"""What paces K1's AM pair (csrc/sweep_chain.cuh's am_pair_kernel: a cluster
of two blocks a channel, chunks alternating between them, the carries handed
over through distributed shared memory): the pair against builds that take
its hand-offs or its partner away, timed on one CUDA card at bench_full.py's
config1 (64 channels x 2^19), without and with the blanker. Each variant is
csrc/ with a line replaced, built into a directory of its own and timed in
a process of its own:

  shipped  the pair and the one-block form as the sources stand;
  nowait   the pair with every wait for a hand-off taken out: each block
           runs its chunks at its own pace, the stores, arrivals, copies and
           barriers of the hand-offs left in (its outputs are not the chain's);
  half     the one-block form over every other chunk: a block's own work in
           the pair without any hand-off (its outputs are not the chain's).

shipped's pair near nowait: the blocks' own work paces the pair, not the
waits; nowait near half: the hand-offs' stores and copies cost about nothing.

    python -m radiodsp_sdr_rx_tpu_torch.diag.am_pair
"""
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from radiodsp_sdr_rx_tpu_torch.utils import build

OUT = build.BUILD_DIR / "am_pair"
EDITS = {
    "shipped": [],
    "nowait": [("sweep_chain.cuh", "  uint32_t done;\n  do {", "  return;\n  uint32_t done;\n  do {")],
    "half": [("sweep_chain.cuh", "for (int row0 = 0; row0 < nrows; row0 += kRows) {",
              "for (int row0 = 0; row0 < nrows; row0 += 2 * kRows) {")],
}
# the forms each variant times: blocks a channel
FORMS = {"shipped": (2, 1), "nowait": (2,), "half": (1,)}


def make(name):
    """csrc/ with the variant's edits, in OUT/name/csrc."""
    csrc = OUT / name / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(build.CSRC, csrc)
    for file, old, new in EDITS[name]:
        text = (csrc / file).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {file} holds {old!r} {text.count(old)} times")
        (csrc / file).write_text(text.replace(old, new))


def use(name):
    build.CSRC, build.BUILD_DIR = OUT / name / "csrc", OUT / name / "_build"


def time_ms(fn, reps=10):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def measure(name):
    from radiodsp_sdr_rx_tpu_torch.diag.compare_builds import C0, scene
    from radiodsp_sdr_rx_tpu_torch.models.config import AGCMode, DemodMode, ReceiverConfig
    from radiodsp_sdr_rx_tpu_torch.models.fused import FusedAMBank
    from radiodsp_sdr_rx_tpu_torch.ops import sweep
    use(name)
    c, n, line = 64, 1 << 19, []
    xr, xi = scene(c, n, c)
    for nb in (False, True):
        cfg = ReceiverConfig(mode=DemodMode.AM, vfo_freq=7_060_000.0, capture_center_freq=C0,
                             agc=AGCMode.OFF, noise_blanker=nb)
        bank = FusedAMBank(cfg, [C0 + 1000.0 * k for k in range(c)])
        args = bank.chain_args(xr, xi, bank.init_state())
        for split in FORMS[name]:
            ms = [time_ms(lambda: sweep.sweep_am_chain(*args, _split=split)) for _ in range(2)]
            line.append(f"am{'_nb' if nb else ''} {'pair' if split == 2 else 'one block'} "
                        + " / ".join(f"{v:.3f}" for v in ms) + " ms")
    print(f"{name}: " + ", ".join(line), flush=True)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--measure":
        return measure(sys.argv[2])
    if not torch.cuda.is_available():
        sys.exit("am_pair: needs a CUDA card")
    for name in EDITS:
        make(name)

    def build_variant(name):
        return subprocess.run([sys.executable, "-c", (
            "import sys; from radiodsp_sdr_rx_tpu_torch.diag import am_pair as p; "
            "from radiodsp_sdr_rx_tpu_torch.utils import build; p.use(sys.argv[1]); "
            "build.load_library('sweep_chain')"), name], check=True)

    with ThreadPoolExecutor(len(EDITS)) as pool:
        list(pool.map(build_variant, EDITS))
    for name in ("shipped", "nowait", "half", "shipped"):
        subprocess.run([sys.executable, "-m", "radiodsp_sdr_rx_tpu_torch.diag.am_pair",
                        "--measure", name], check=True)


if __name__ == "__main__":
    main()
