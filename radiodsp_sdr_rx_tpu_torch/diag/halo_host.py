"""Where an exchange of K9 in one process (``parallel/halo.ring_shift_right``)
spends its time on the host, timed on one CUDA card: a chain of 100
exchanges of 4 shards of (128, 128) complex64 on cuda:0 (chip_smoke.py's
phase 7f), each exchange's output the next one's input.

For each checkout it prints, per exchange: the time by CUDA events and by
the host's clock (no wait inside the chain), the four ``copy_`` into
buffers that compute the same (the library call) by CUDA events, the
device's busy time by the profiler, and the profiler's self time on the host
by operation. With several checkouts it runs each in a process of its own,
in turns (A, B, B, A for two), so that two versions are compared in one call
on one card.

    python radiodsp_sdr_rx_tpu_torch/diag/halo_host.py [ROOT ...]

ROOT (default: the checkout holding this file) is a checkout whose
``radiodsp_sdr_rx_tpu_torch`` is measured: unpack the parent with
``git archive`` into an ignored directory to time it beside this one. Its
kernels are built from that checkout's sources.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

EXCHANGES = 100
SHARDS, BLOCK = 4, (128, 128)


def measure(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    from radiodsp_sdr_rx_tpu_torch.parallel import halo

    if not torch.cuda.is_available():
        sys.exit("halo_host: no CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    blocks = [torch.randn(BLOCK, generator=gen, device="cuda", dtype=torch.complex64)
              for _ in range(SHARDS)]
    bufs = [torch.empty_like(b) for b in blocks]

    def copies(x):
        for s, buf in enumerate(bufs):
            buf.copy_(x[s - 1])
        return bufs

    def chain(fn):
        x = blocks
        for _ in range(EXCHANGES):
            x = fn(x)
        return x

    def events_us(fn, reps=3):
        chain(fn)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            chain(fn)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / reps / EXCHANGES

    same = all(torch.equal(a, b) for a, b in zip(halo.ring_shift_right(blocks),
                                                 halo.ring_shift_right_plain(blocks)))
    kernel = [events_us(halo.ring_shift_right) for _ in range(2)]
    library = [events_us(copies) for _ in range(2)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    chain(halo.ring_shift_right)
    host = (time.perf_counter() - t) * 1e6 / EXCHANGES
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        chain(halo.ring_shift_right)
        torch.cuda.synchronize()
    device = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / EXCHANGES
    split = sorted(((e.self_cpu_time_total / EXCHANGES, e.key) for e in prof.key_averages()
                    if e.self_cpu_time_total > 0), reverse=True)
    print(f"{root}: bit for bit the plain copies {same}; us per exchange: kernel "
          f"{', '.join(f'{v:.2f}' for v in kernel)} (CUDA events), {host:.2f} (the host's clock, "
          f"no wait), library (4 copy_) {', '.join(f'{v:.2f}' for v in library)}; device busy "
          f"{device:.2f}; the host's self time by the profiler (us an exchange, under it): "
          + ", ".join(f"{k} {v:.2f}" for v, k in split[:8]), flush=True)


def main(argv: list[str]) -> None:
    if argv[:1] == ["--measure"]:
        measure(argv[1])
        return
    here = str(Path(__file__).resolve().parents[2])
    roots = [str(Path(r).resolve()) for r in argv] or [here]
    order = roots + roots[::-1] if len(roots) > 1 else roots
    for root in order:
        subprocess.run([sys.executable, __file__, "--measure", root], check=True, timeout=600)


if __name__ == "__main__":
    main(sys.argv[1:])
