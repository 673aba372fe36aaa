"""What K1's SSB chain spends its time on: its two products against the rest
(the mix, the blanker, the AGC's scans, the barriers and the stores), timed on
one CUDA card at the main path's shape (128 channels x 2^19) for
sweep_chain_ssb_nb (the blanker path, on its impulse scene) and
sweep_chain_ssb (the main path, on noise). Each variant is csrc/ with lines
replaced, built into a directory of its own and timed in a process of its
own, the variants in turns:

  shipped   the sources as they stand;
  noprod    both products taken out: the accumulators zero, the barrier each
            product ends at kept (what the rest of the chain costs);
  prodonly  the mix (with the blanker) and the AGC taken out: the products,
            the stores and the barriers between them (what the products cost).

The products' share is shipped - noprod, and about prodonly; the rest's is
shipped - prodonly, and about noprod. Neither variant's outputs are the
chain's. The edits follow the checkout's sources: chunk_gemm's fp32 FMA for
every instantiation (before csrc/tc_gemm.cuh), or K1-nb on the 3xTF32
tensor-core engine of csrc/tc_gemm.cuh (the chain kernel's product policy
Tf32x3) and K1-ssb on chunk_gemm.

    python radiodsp_sdr_rx_tpu_torch/diag/k1_split.py [ROOT]

ROOT (default: the checkout holding this file) is the checkout measured, so
that an unpacked parent can be measured with the same script.
"""
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# ``--build NAME ROOT`` and ``--measure NAME ROOT`` are the per-variant
# processes the run starts
MODE = sys.argv[1] if len(sys.argv) > 3 and sys.argv[1].startswith("--") else None
ROOT = (Path(sys.argv[-1]) if len(sys.argv) > 1 else Path(__file__).parents[2]).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from radiodsp_sdr_rx_tpu_torch.utils import build  # noqa: E402

OUT = build.BUILD_DIR / "k1_split"
# the chunk loop of sweep_chain_kernel: its mix, its AGC and, for each
# engine, its two products (each edit's text occurs once in sweep_chain.cuh)
_MIX = ("    mix_rows<kNB, BlockSync>(a, cc, Mr, Mi, keep_row, seg, env_c, base, row0, rows);\n",
        "")
_AGC = ("    agc_rows<BlockSync>(a, cc, Ab, rows, seg, env_c);\n", "")
_FMA_BAND = ("        float acc[8][4];\n        chunk_gemm<128>(Mr, Mi, a.w_band, 512, As, Bs, acc);",
             "        float acc[8][4] = {};\n        __syncthreads();")
_FMA_PBT = ("    float lr[8][8];\n    chunk_gemm<256>(Ab, Ab, a.w_pbt, 256, As, Bs, lr);\n"
            "    if (tid < kBlk)",
            "    float lr[8][8] = {};\n    __syncthreads();\n    if (tid < kBlk)")
# the same two products on the tensor cores (the product policy Tf32x3)
_TC_BAND = ("        Tf32x3::Acc<128> acc;\n"
            "        Tf32x3::gemm<128>(Mr, Mi, a.w_band, 512, As, acc);",
            "        Tf32x3::Acc<128> acc = {};\n        __syncthreads();")
_TC_PBT = ("    std::conditional_t<kTc, Tf32x3::Acc<256>, float[8][8]> lr;\n"
           "    if constexpr (kTc)\n      Tf32x3::gemm<256>(Ab, Ab, a.w_pbt, 256, As, lr);\n"
           "    else\n      chunk_gemm<256>(Ab, Ab, a.w_pbt, 256, As, Bs, lr);",
           "    std::conditional_t<kTc, Tf32x3::Acc<256>, float[8][8]> lr = {};\n"
           "    __syncthreads();")
EDITS = {
    "fma": {"shipped": [], "noprod": [_FMA_BAND, _FMA_PBT], "prodonly": [_MIX, _AGC]},
    "tf32x3": {"shipped": [], "noprod": [_FMA_BAND, _TC_BAND, _TC_PBT], "prodonly": [_MIX, _AGC]},
}
KERNELS = ("sweep_chain_ssb_nb", "sweep_chain_ssb")


def engine():
    return "tf32x3" if (build.CSRC / "tc_gemm.cuh").exists() else "fma"


def make(name):
    """csrc/ with the variant's edits, in OUT/name/csrc."""
    csrc = OUT / name / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(build.CSRC, csrc)
    for old, new in EDITS[engine()][name]:
        text = (csrc / "sweep_chain.cuh").read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: sweep_chain.cuh holds {old!r} "
                               f"{text.count(old)} times")
        (csrc / "sweep_chain.cuh").write_text(text.replace(old, new))


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
    from radiodsp_sdr_rx_tpu_torch.models.config import AGCMode, DemodMode, ReceiverConfig
    from radiodsp_sdr_rx_tpu_torch.models.fused import FusedSSBBank
    from radiodsp_sdr_rx_tpu_torch.ops import sweep
    use(name)
    c, n, line = 128, 1 << 19, []
    g = torch.Generator(device="cuda").manual_seed(0)
    cfg = ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_200_000.0,
                         capture_center_freq=7_190_000.0, agc=AGCMode.MEDIUM)
    freqs = [7_190_000.0 + 1_000.0 * k for k in range(c)]
    for kname in KERNELS:
        nb = kname.endswith("_nb")
        xr, xi = (torch.randn((c, n), generator=g, device="cuda") * (0.05 if nb else 0.1)
                  for _ in range(2))
        bank = FusedSSBBank(cfg.with_(noise_blanker=nb), freqs)
        state = bank.init_state()
        if nb:   # chip_smoke.py's impulse scene: clipped noise, impulses of 8(1+1j)
            mag = torch.hypot(xr, xi)
            f = (2.2 * mag.mean() / mag.clamp(min=1e-12)).clamp(max=1.0)
            xr, xi = xr * f, xi * f
            for pos in (500, 1733, n // 2 + 7, n - 3, n - 1):
                xr[:, pos] = 8.0
                xi[:, pos] = 8.0
            state = state._replace(nb_avg=torch.full((c,), float(torch.hypot(xr, xi).mean()),
                                                     device="cuda"))
        args = bank.chain_args(xr, xi, state)
        ms = [time_ms(lambda: sweep.sweep_full_chain(*args)) for _ in range(2)]
        line.append(f"{kname} " + " / ".join(f"{v:.3f}" for v in ms) + " ms")
    print(f"{name} ({engine()}): " + ", ".join(line), flush=True)


def main():
    if MODE == "--measure":
        return measure(sys.argv[2])
    if MODE == "--build":
        use(sys.argv[2])
        build.load_library("sweep_chain")
        return None
    if not torch.cuda.is_available():
        sys.exit("k1_split: needs a CUDA card")
    print(f"k1_split on {ROOT}, product engine of K1-nb: {engine()}; "
          + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip(), flush=True)
    for name in EDITS[engine()]:
        make(name)

    def build_variant(name):
        return subprocess.run([sys.executable, __file__, "--build", name, str(ROOT)], check=True)

    with ThreadPoolExecutor(len(EDITS[engine()])) as pool:
        list(pool.map(build_variant, EDITS[engine()]))
    for name in ("shipped", "noprod", "prodonly", "shipped"):
        subprocess.run([sys.executable, __file__, "--measure", name, str(ROOT)], check=True)
    return None


if __name__ == "__main__":
    main()
