"""Tracing and timing (``radiodsp_sdr_rx_tpu/utils/profiling.py``).

- ``trace(logdir)``: ``torch.profiler`` around a block of work, the host and
  the card, written into ``logdir`` as a Chrome trace (chrome://tracing,
  Perfetto).
- ``time_stage``: the host clock around calls of a function, closed by
  ``torch.cuda.synchronize`` when its output is on a card (PyTorch returns
  before the card is done).
- ``stage_report``: samples/s of the receiver chain's main stages, built
  from the port's plain stages on the card: the DDS mix, the sideband filter
  + SSB demod, the AGC and the PBT filter.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.utils.convert import resolve_device


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Profile the block into ``logdir``/trace_<pid>_<ns>.json: the host's
    operators and, on a card (``device=None``), its kernels and copies;
    ``device="cpu"`` traces the host alone. Yields the profiler."""
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)   # the block's kernels end inside the trace
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _tensors(out):
    if torch.is_tensor(out):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)


def _force(out) -> None:
    """Wait for the card behind ``out``'s tensors (nothing to wait for on
    the CPU, which computes eagerly)."""
    for dev in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def time_stage(fn, *args, reps: int = 10, warmup: int = 2) -> dict:
    """Wall-clock time of ``fn(*args)``, completion forced. Returns
    {'seconds_per_call', 'calls_per_s'}."""
    out = fn(*args)
    _force(out)
    for _ in range(warmup):
        out = fn(*args)
    _force(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    _force(out)
    dt = (time.perf_counter() - t0) / reps
    return {"seconds_per_call": dt, "calls_per_s": 1.0 / dt}


def stage_report(config=None, n_channels: int = 16, seg_len: int = 1 << 16,
                 reps: int = 5, device=None) -> dict:
    """Msamples/s and ms a call of the chain's main stages on (n_channels,
    seg_len) planes of noise on ``device`` (None: the card)."""
    from radiodsp_sdr_rx_tpu_torch.models.config import ReceiverConfig
    from radiodsp_sdr_rx_tpu_torch.models.receiver import build_params
    from radiodsp_sdr_rx_tpu_torch.ops import agc as agc_ops
    from radiodsp_sdr_rx_tpu_torch.ops import planar

    dev = resolve_device(device)
    p = build_params(config or ReceiverConfig())
    rng = np.random.default_rng(0)

    def put(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    xr = put(rng.standard_normal((n_channels, seg_len)) * 0.1)
    xi = put(rng.standard_normal((n_channels, seg_len)) * 0.1)
    zeros = torch.zeros(n_channels, 128, device=dev)
    env0 = torch.full((n_channels,), 1e-6, device=dev)
    incs = torch.full((n_channels,), int(p.nco_inc), dtype=torch.int64, device=dev)
    ph0 = torch.zeros(n_channels, dtype=torch.int64, device=dev)
    w_ssb, w_pbt = put(p.w_ssb), put(p.w_pbt)
    agc_p = agc_ops.AGCParams(release=float(p.agc_release), target=float(p.agc_target),
                              max_gain=float(p.agc_max_gain), enabled=bool(p.agc_enabled))

    samples = n_channels * seg_len
    report = {}
    for name, fn in [
        ("nco_mix", lambda: planar.nco_mix_planar(xr, xi, ph0, incs)[:2]),
        ("ssb_filter_demod", lambda: planar.ssb_filter_demod_planar(xr, xi, w_ssb, zeros,
                                                                    zeros)[0]),
        ("agc", lambda: agc_ops.agc_run(xr, agc_p, env0)[0]),
        ("pbt_filter", lambda: planar.pbt_filter_planar(xr, w_pbt, zeros)[0]),
    ]:
        t = time_stage(fn, reps=reps)
        report[name] = {"msamples_per_s": samples / t["seconds_per_call"] / 1e6,
                        "ms_per_call": t["seconds_per_call"] * 1e3}
    return report
