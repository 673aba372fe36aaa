"""What K2a (mix_demod) and K8 (sweep_mix_demod) spend their time on, timed
on one CUDA card at the main path's shape (128 channels x 2^19) on variants
of csrc/, each built into a directory of its own and timed in a process of
its own, the variants in turns. Both kernels are csrc/staged.cu's
mix_demod_kernel: the band-pass product as 3xTF32 on the tensor cores, fed
from the operator's pre-laid image (ops/staged.mix_image).

The variants:

  shipped   the sources as they stand: 128-row items, one block an SM, both
            warpgroups reading each 8 KB K step of the image (one part),
            warpgroup w multiplying rows 64 w.. of the item, four K steps (32
            KB) a bulk copy of the producer warp into a ring of two slots;
            the item's mix without a branch, four rows loaded ahead;
  noprod    the product taken out: no pass issued, no copy issued or waited
            for, the accumulators zero (what the loads, the mix and the
            stores cost);
  tconly    the passes without the feed: wgmma on the slots as they lie, no
            copy issued or waited for (what the tensor cores and A cost);
  feedonly  the feed without the passes: every unit waited for and released,
            no wgmma (what the copies cost);
  pair64    K1-ssb's 64-row form: 64-row items, two blocks an SM, the
            image of ops/sweep.ssb_image (the band-pass split over K, each 16
            KB K step of both warpgroups one bulk copy into a ring of two 16
            KB slots), the two parts added through shared memory (fed_to_rows)
            and stored from there; one block's loads and mix may overlap the
            other's passes, at twice the image's L2 reads;
  noload    noprod without the mix's loads (the mix of zeros), and
  nomix     noprod without the mix (the samples scaled and stored as they
            are): what the mix's loads and its arithmetic each cost;
  stagger4  block b's chain waits (b mod 4) x 7,000 cycles (about a quarter
            of an item) before its first item (the producer starts at once),
            so that the blocks' mixes, bound by their loads, do not all fall
            together;
  rawfeed   K2b's raw feed (tc::gemm<128, 4, true>): 64-row items, one block
            an SM, every thread copying the raw fp32 operator by cp.async
            and splitting it into the stages wgmma reads, the product split
            over K and the parts added in shared memory (to_rows).

Beside each time, the operator's bytes a segment that the blocks copy out of
the L2, by count (not measured): the image for every 128-row item (shipped)
or 64-row item (pair64), the raw operator for every 64-row item (rawfeed).
noprod, tconly, feedonly, noload and nomix do not compute the function: their errors are
printed but mean nothing. Each variant's K2a output is also held bit for bit
to shipped's (kept in the build directory under a hash of the sources
measured): stagger4 changes nothing the kernel computes and gives the same
bits. shipped also runs on 16, 32 and 64 channels:
a per-SM pace keeps the segment's time per item, a pace shared over the
card (the L2) drops with the blocks.

    python radiodsp_sdr_rx_tpu_torch/diag/k2a_split.py [--variants a,b,...] [ROOT]
    python radiodsp_sdr_rx_tpu_torch/diag/k2a_split.py --paths [ROOT]

ROOT (default: the checkout holding this file) is the checkout measured.
--paths times, through the public entry points alone (so that an unpacked
parent checkout can be timed as well, in turns with this one): the staged
FusedSSBBank and FusedNRBank config3 notch fold=False per segment, K2a, K8
and the AGC between K2a and K2b (agc_run) alone, at 128 x 2^19.
"""
import hashlib
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# ``--build NAME ROOT`` and ``--measure NAME ROOT`` are the per-variant
# processes the run starts
MODE = sys.argv[1] if sys.argv[1:2] in (["--build"], ["--measure"], ["--paths"]) else None
ONLY = sys.argv[2].split(",") if sys.argv[1:2] == ["--variants"] else None
_ROOT_ARG = sys.argv[{"--build": 3, "--measure": 3, "--paths": 2}.get(MODE, 3 if ONLY else 1):]
ROOT = (Path(_ROOT_ARG[0]) if _ROOT_ARG else Path(__file__).parents[2]).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from radiodsp_sdr_rx_tpu_torch.utils import build  # noqa: E402

OUT = build.BUILD_DIR / "k2a_split"
ST, TC = "staged.cu", "tc_gemm.cuh"
# the fed engine's three passes (its descriptors' line makes the text unique)
_PASSES = (TC, "kKS * kNC);\n    fence();\n    wgmma(acc, as, db);\n    wgmma(acc, ab, ds);\n"
               "    wgmma(acc, ab, db);\n    commit();\n  };",
           "kKS * kNC);\n    (void)db;\n    (void)ds;\n  };")
_NO_FEED = [(TC, "    if (s % feed::kUnitSteps == 0) f.wait(i);\n", ""),
            (TC, "    if (s >= 1 && s % feed::kUnitSteps == 0) f.release(i0 + s / feed::kUnitSteps - 1);\n",
             ""),
            (TC, "  wait<0>();\n  f.release(i0 + units - 1);", "  wait<0>();"),
            (TC, "    if (!producer()) return;\n    for (int u = 0; u < total; ++u) {",
             "    return;\n    for (int u = 0; u < total; ++u) {")]
# the shipped kernel's product and stores, and its launch, which pair64 and
# rawfeed replace
_PRODUCT = """    ChainSync::sync();
    tc::Acc<128, true> acc;
    tc::fed_gemm<128, false, 1>(Mr + half * kLd, Mi + half * kLd, feed, kMixUnits, acc);
    store_item(acc, a.audio, (size_t)c * a.n, row0 + half, rows - half,
               kTail ? 1.f : a.out_gain);
"""
# the item's rows from row 1 of a row buffer to device memory times the gain,
# then a barrier before the next item's mix overwrites the buffer
_STORE = """    for (int e = threadIdx.x; e < rows * kBlk; e += kThreads)
      a.audio[(size_t)c * a.n + (size_t)row0 * kBlk + e] =
          Mr[(e / kBlk + 1) * kLd + e % kBlk] * (kTail ? 1.f : a.out_gain);
    ChainSync::sync();
"""
_LAUNCH = "  mix_demod_kernel<kTail><<<min(items, sms), kThreads + 32, kMixSmem, (cudaStream_t)stream>>>(a);"
_64ROWS = (ST, "constexpr int kItemRows = 2 * kRows;", "constexpr int kItemRows = kRows;")
PAIR64 = [
    _64ROWS,
    (TC, "constexpr int kUnitSteps = 4;", "constexpr int kUnitSteps = 1;"),
    (ST, "constexpr int kMixUnits = 512 / tc::kKS / tc::feed::kUnitSteps;",
     "constexpr int kMixUnits = 512 / tc::kKS / 2;"),
    (ST, "constexpr int kMixSlot = tc::feed::kUnitSteps * 2 * tc::kKS * kBlk;",
     "constexpr int kMixSlot = 2 * 2 * tc::kKS * kBlk;"),
    (ST, "__launch_bounds__(kThreads + 32, 1) mix_demod_kernel",
     "__launch_bounds__(kThreads + 32, 2) mix_demod_kernel"),
    (ST, _PRODUCT, """    ChainSync::sync();
    tc::Acc<128, true> acc;
    tc::fed_gemm<128, true>(Mr, Mi, feed, kMixUnits, acc);
    (void)half;
    tc::fed_to_rows(acc, Mr);
""" + _STORE),
    (ST, _LAUNCH, _LAUNCH.replace("min(items, sms)", "min(items, 2 * sms)"))]
RAWFEED = [
    _64ROWS,
    (ST, "__launch_bounds__(kThreads + 32, 1) mix_demod_kernel",
     "__launch_bounds__(kThreads, 1) mix_demod_kernel"),
    (ST, "constexpr int kMixSmem = 4 * (tc::feed::kSlots * kMixSlot + 2 * kItemBuf) + 8 * tc::feed::kBars;",
     "constexpr int kMixSmem = 4 * (tc::tile_floats<128, 4, true>() + 2 * kItemBuf);"),
    (ST, "  float* Mr = smem + tc::feed::kSlots * kMixSlot;",
     "  float* Mr = smem + tc::tile_floats<128, 4, true>();"),
    (ST, """  tc::Feed<MixPlan, kMixSlot> feed{MixPlan{a.image}, smem, bars, mine * kMixUnits, 0};
  feed.setup();
  __syncthreads();            // the ring's barriers set up before any copy or wait
  if (threadIdx.x >= kThreads) {
    feed.produce();
    return;
  }
""", "  (void)bars;\n  (void)mine;\n"),
    (ST, _PRODUCT, """    __syncthreads();
    tc::Acc<128, true> acc;
    tc::gemm<128, 4, true>(Mr, Mi, a.image, 512, smem, acc);
    (void)half;
    tc::to_rows(acc, Mr);
""" + _STORE),
    (ST, _LAUNCH, _LAUNCH.replace("kThreads + 32", "kThreads"))]
# block b's chain waits (b mod 4) x 7,000 cycles before its first item (the
# producer starts at once), so that the blocks' mixes, each bound by its
# loads, do not all fall at the same time
STAGGER4 = [(ST, "  const int half = kRows * (threadIdx.x >> 7);      // the warpgroup's first row of an item\n",
             "  const int half = kRows * (threadIdx.x >> 7);      // the warpgroup's first row of an item\n"
             "  for (const long long t0 = clock64(); clock64() - t0 < (long long)(blockIdx.x % 4) * 7000;) {}\n")]


# diagnostics of the mix alone (with noprod): no loads (the mix of zeros), or
# the loads without the mix (the samples scaled and stored as they are)
NOLOAD = [(ST, "        x[u] = __ldg(reinterpret_cast<const float4*>(a.xr + o));\n"
               "        y[u] = __ldg(reinterpret_cast<const float4*>(a.xi + o));\n",
           "        (void)o;\n")]
NOMIX = [(ST, "        mix<true>(xs[e], ys[e], ph0 + (uint32_t)pos * dph, g_i, g_q, vr, vi);",
          "        vr = xs[e] * g_i;\n        vi = ys[e] * g_q;\n        (void)pos;")]
EDITS = {"shipped": [], "noprod": [_PASSES, *_NO_FEED], "tconly": _NO_FEED, "feedonly": [_PASSES],
         "pair64": PAIR64, "rawfeed": RAWFEED, "noload": [_PASSES, *_NO_FEED, *NOLOAD],
         "nomix": [_PASSES, *_NO_FEED, *NOMIX], "stagger4": STAGGER4}
ROWS = {"pair64": 64, "rawfeed": 64}   # rows an image read serves; 128 elsewhere


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


def time_ms(fn, reps=20):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def l2_bytes(name, c, n):
    """The operator's bytes a segment copied out of the L2, by count: 256 KB
    of the operator (512 KB of image) an item."""
    rows = ROWS.get(name, 128)   # rows an item read the image once
    return c * -(-n // (128 * rows)) * (256 if name == "rawfeed" else 512) * 1024


def shipped_out():
    """Where shipped's K2a output is kept: under a hash of the sources
    measured, so that a run after an edit never compares with an older
    build's."""
    files = sorted(f for f in build.CSRC.iterdir() if f.is_file())
    return OUT / f"shipped-{hashlib.sha256(b''.join(f.read_bytes() for f in files)).hexdigest()[:16]}.pt"


def measure(name):
    import numpy as np
    from radiodsp_sdr_rx_tpu_torch.ops import fir_design, nco, staged, sweep
    from radiodsp_sdr_rx_tpu_torch.ops.operators import ssb_demod_operator
    kept = shipped_out()   # of the sources measured, before use() points at the variant's
    use(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    c, n = 128, 1 << 19
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.as_tensor(np.ascontiguousarray(ssb_demod_operator(
        fir_design.design_filter_mask(300.0, 4000.0, 44117.64706))), device=dev)
    xr, xi = (torch.randn((c, n), generator=gen, device=dev) * 0.1 for _ in range(2))
    inc = torch.tensor([int(nco.freq_to_phase_inc(1000.0 * k, 44117.64706)) for k in range(c)],
                       dtype=torch.int64, device=dev)
    ph = torch.randint(0, 2**32, (c,), generator=gen, device=dev, dtype=torch.int64)
    tail = torch.randn((c, 256), generator=gen, device=dev) * 0.1
    g_i, g_q = float(np.float32(0.7)), float(np.float32(0.7) * np.float32(1.02))
    # the operator as the variant reads it
    image = {"pair64": lambda: sweep.ssb_image(w, torch.zeros((256, 256), device=dev)).band,
             "rawfeed": lambda: w}.get(name, lambda: staged.mix_image(w))()

    def k2a(cc=c):
        audio = torch.empty((cc, n), device=dev)
        staged.launch("mix_demod", dev, *(t.data_ptr() for t in (xr, xi, inc, ph, image, tail,
                                                                  audio)), cc, n, 0, g_i, g_q)
        return audio

    def k8():
        audio = torch.empty_like(xr)
        staged.launch("sweep_mix_demod", dev, *(t.data_ptr() for t in (xr, xi, inc, ph, image,
                                                                        audio)), c, n, 0, 1.0)
        return audio

    out = k2a()
    err = float((out - staged.fused_mix_filter_demod_plain(xr, xi, inc, ph, w, tail, g_i,
                                                          g_q)).abs().max())
    if name == "shipped" and not kept.exists():
        torch.save(out.cpu(), kept)
    same = torch.equal(out.cpu(), torch.load(kept))
    err8 = float((k8() - sweep.sweep_mix_filter_demod_plain(xr, xi, inc, ph, w)).abs().max())
    ms = [time_ms(k2a) for _ in range(2)]
    ms8 = [time_ms(k8) for _ in range(2)]
    line = (f"{name}: K2a " + " / ".join(f"{v:.3f}" for v in ms) + f" ms (max |kernel - plain| "
            f"{err:.1e}; bit for bit shipped's: {same}), K8 "
            + " / ".join(f"{v:.3f}" for v in ms8) + f" ms ({err8:.1e}), "
            f"operator {l2_bytes(name, c, n) / 1e9:.2f} GB of L2 reads by count")
    if name == "shipped":   # the same kernel on fewer blocks
        line += ", K2a on " + ", ".join(f"{cc} channels {time_ms(lambda: k2a(cc)):.3f} ms"
                                        for cc in (16, 32, 64))
    print(line, flush=True)


def paths():
    from radiodsp_sdr_rx_tpu_torch.models.config import (AGCMode, DemodMode, NRMode,
                                                         ReceiverConfig)
    from radiodsp_sdr_rx_tpu_torch.models.fused import FusedNRBank, FusedSSBBank
    from radiodsp_sdr_rx_tpu_torch.ops import agc, staged, sweep
    torch.backends.cuda.matmul.allow_tf32 = False
    c, n = 128, 1 << 19
    gen = torch.Generator(device="cuda").manual_seed(0)
    xr, xi = (torch.randn((c, n), generator=gen, device="cuda") * 0.1 for _ in range(2))
    usb = ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_200_000.0,
                         capture_center_freq=7_190_000.0, agc=AGCMode.MEDIUM)
    bank = FusedSSBBank(usb, [7_190_000.0 + 1_000.0 * k for k in range(c)], backend="staged")
    st = bank.init_state()
    cw = ReceiverConfig(mode=DemodMode.CW_NARROW, vfo_freq=14_050_000.0,   # bench_full.py config3
                        capture_center_freq=14_049_000.0, agc=AGCMode.FAST, nr=NRMode.NOTCH)
    nr = FusedNRBank(cw, [14_049_000.0 + 1_000.0 * k for k in range(c)], fold=False)
    st_nr = nr.init_state()
    args = bank.mix_demod_args(xr, xi, st)
    audio = staged.fused_mix_filter_demod(*args)
    ms = {"staged": lambda: bank.process_planar(xr, xi, st),
          "config3 fold=False": lambda: nr.process_planar(xr, xi, st_nr),
          "K2a": lambda: staged.fused_mix_filter_demod(*args),
          "agc_run": lambda: agc.agc_run(audio, bank.agc_params, st.agc_env),
          "K8": lambda: sweep.sweep_mix_filter_demod(xr, xi, bank.incs, st.nco_phase,
                                                     bank.params.w_ssb)}
    print(f"paths of {ROOT}: " + ", ".join(f"{k} {time_ms(fn, 10):.3f} ms" for k, fn in ms.items()),
          flush=True)


def main():
    if MODE == "--paths":
        return paths()
    if MODE == "--measure":
        return measure(sys.argv[2])
    if MODE == "--build":
        use(sys.argv[2])
        build.load_library("staged")
        print(build.build_log("staged"), flush=True)
        return None
    if not torch.cuda.is_available():
        sys.exit("k2a_split: needs a CUDA card")
    print(f"k2a_split on {ROOT}; " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    names = [n for n in EDITS if ONLY is None or n in ONLY or n == "shipped"]
    for name in names:
        make(name)

    def build_variant(name):
        return subprocess.run([sys.executable, __file__, "--build", name, str(ROOT)],
                              capture_output=True, text=True)

    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(build_variant, names)))
    for name, proc in built.items():
        if proc.returncode:
            print(f"{name}: the build failed:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}",
                  flush=True)
        else:   # ptxas' registers and spills of the two kernels
            print(f"{name} ptxas: " + "; ".join(
                ln.strip() for ln in proc.stdout.splitlines()
                if "mix_demod_kernel" in ln or ("registers" in ln and "Used" in ln)), flush=True)
    names = [n for n in names if not built[n].returncode]
    for name in [*names, "shipped"]:
        subprocess.run([sys.executable, __file__, "--measure", name, str(ROOT)], check=True)
    return None


if __name__ == "__main__":
    main()
