"""The PLL kernels built with other warp layouts of their block, timed on one
CUDA card: K7 (sam_wide, _nb at 1,024 x 2^17), SAM + spectral
(lanes_sam_spectral, _nb) and sweep_chain_sam (_nb) at 128 x 2^17. Each
variant is csrc/ with a line or two replaced, built into a directory of its
own, and timed in a process of its own:

  shipped       as the sources stand;
  chain         every PLL kernel on ChainSync's nine-warp block (the walk on
                warp 8, beside chain warps 0 and 4 on its scheduler);
  solo          SoloSync's twelve-warp block for sweep_chain_sam too;
  solo_shared   SoloSync's map with one chain warp beside the walker
                (chain warps 3/2/2 on the other three schedulers);
  *_nowalk      shipped and chain without the walk: the chain alone.

The SAM x LMS routes keep ChainSync in every variant: lms_step.cuh's walk
reads its warp's role from the physical warp. Every variant's outputs but the
no-walk ones' are held to the shipped build's, bit for bit.

    python -m radiodsp_sdr_rx_tpu_torch.diag.warp_layouts
"""
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from radiodsp_sdr_rx_tpu_torch.utils import build

OUT = build.BUILD_DIR / "layouts"
LIBRARIES = ("sam_wide", "sweep_spec", "sweep_chain")
SOLO = "std::conditional_t<kNR == Nr::kSpectral, SoloSync, ChainSync>"
EDITS = {
    "chain": [("sam_wide.cu", "using Sync = SoloSync;", "using Sync = ChainSync;"),
              ("sweep_chain.cuh", SOLO, "ChainSync")],
    "solo": [("sweep_chain.cuh", SOLO, "std::conditional_t<is_lms(kNR), ChainSync, SoloSync>")],
    "solo_shared": [("chain_common.cuh", "kSoloMap = 0xb76a54392108ull",
                     "kSoloMap = 0xba7965423018ull")],
}
NO_WALK = [("sam_wide.cu", "    if (!walker) return;\n", "    return;\n"),
           ("sweep_chain.cuh", "    if (tid != kThreads) return;\n", "    return;\n")]
EDITS["shipped_nowalk"] = NO_WALK
EDITS["chain_nowalk"] = EDITS["chain"] + NO_WALK
VARIANTS = ["shipped", "chain", "solo", "solo_shared", "shipped_nowalk", "chain_nowalk"]


def make(name):
    """csrc/ with the variant's edits, in OUT/name/csrc."""
    csrc = OUT / name / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(build.CSRC, csrc)
    for file, old, new in EDITS.get(name, []):
        text = (csrc / file).read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: {file} no longer holds {old!r}")
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
    """Time the variant's PLL kernels; save their first outputs."""
    from radiodsp_sdr_rx_tpu_torch.diag.compare_builds import C0, scene
    from radiodsp_sdr_rx_tpu_torch.models.config import (
        AGCMode, DemodMode, NRMode, ReceiverConfig)
    from radiodsp_sdr_rx_tpu_torch.models.fused import FusedNRBank, FusedSAMBank
    from radiodsp_sdr_rx_tpu_torch.ops import lanes, sam_wide, sweep
    use(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ReceiverConfig(mode=DemodMode.SAM, vfo_freq=7_060_000.0, capture_center_freq=C0,
                         agc=AGCMode.MEDIUM)
    n, outs, line = 1 << 17, {}, []
    for c, kind in ((1024, "sam_wide"), (128, "lanes_sam_spectral"), (128, "sweep_chain_sam")):
        xr, xi = scene(c, n, c)
        for nb in (False, True):
            fq = [C0 + 1000.0 * k for k in range(c)]
            if kind == "lanes_sam_spectral":
                bank = FusedNRBank(cfg.with_(nr=NRMode.SPEC2, noise_blanker=nb), fq)
                args, run = bank.lanes_args(xr, xi, bank.init_state()), lanes.sweep_lanes_chain
            else:
                bank = FusedSAMBank(cfg.with_(noise_blanker=nb), fq)
                args = bank.chain_args(xr, xi, bank.init_state())
                run = sam_wide.sweep_sam_wide if kind == "sam_wide" else sweep.sweep_sam_chain
            key = kind + ("_nb" if nb else "")
            outs[key] = [o.cpu() for o in run(*args)[:2]]
            ms = time_ms(lambda: run(*args))
            line.append(f"{key} {ms:.3f} ms ({ms * 1e-3 / n * 1.98e9:.1f} cycles a step at "
                        f"1980 MHz)")
    torch.save(outs, OUT / name / "outputs.pt")
    print(f"{name}: " + ", ".join(line), flush=True)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--measure":
        return measure(sys.argv[2])
    if not torch.cuda.is_available():
        sys.exit("warp_layouts: needs a CUDA card")
    for name in VARIANTS:
        make(name)

    def build_variant(name):
        return subprocess.run([sys.executable, "-c", (
            "import sys; from radiodsp_sdr_rx_tpu_torch.diag import warp_layouts as w; "
            "from radiodsp_sdr_rx_tpu_torch.utils import build; w.use(sys.argv[1]); "
            "[build.load_library(x) for x in w.LIBRARIES]"), name], check=True)

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        list(pool.map(build_variant, VARIANTS))
    for name in VARIANTS:
        subprocess.run([sys.executable, "-m", "radiodsp_sdr_rx_tpu_torch.diag.warp_layouts",
                        "--measure", name], check=True)
    shipped = torch.load(OUT / "shipped" / "outputs.pt")
    for name in VARIANTS:
        if not name.endswith("_nowalk"):
            got = torch.load(OUT / name / "outputs.pt")
            same = all(torch.equal(a, b) for k in shipped for a, b in zip(shipped[k], got[k]))
            print(f"{name}: outputs bit for bit the shipped build's: {same}", flush=True)


if __name__ == "__main__":
    main()
