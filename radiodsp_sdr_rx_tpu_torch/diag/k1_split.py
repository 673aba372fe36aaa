"""What K1's SSB chain spends its time on, timed on one CUDA card at the main
path's shape (128 channels x 2^19) on variants of csrc/, each built into a
directory of its own and timed in a process of its own, the variants in
turns. The edits follow the checkout's sources (ROOT's engine):

  fma     (before csrc/tc_gemm.cuh) sweep_chain_ssb_nb and sweep_chain_ssb
          on chunk_gemm's fp32 FMA;
  tf32x3  (the raw feed) sweep_chain_ssb_nb on the 3xTF32 tensor-core engine, its
          operator copied raw by cp.async and staged split through registers
          (the chain kernel's product policy Tf32x3), sweep_chain_ssb on
          chunk_gemm;
  fed     (the pre-laid feed) sweep_chain_ssb and sweep_chain_ssb_mono on the
          engine's pre-laid feed (ssb_fed_kernel): the operators' images
          (ops/sweep.ssb_image) brought in by bulk copies, one block a
          channel.

The variants:

  shipped   the sources as they stand;
  noprod    both products taken out: the accumulators zero, the barrier each
            product ends at kept (what the rest of the chain costs; fed: no
            copy issued or waited for);
  prodonly  the mix (with the blanker) and the AGC taken out: the products,
            the stores and the barriers between them (what the products cost);
  fed only:
  rawfeed   the engine's raw feed for both, as K1-nb's (kTensorCores widened
            to the SSB chain without the blanker, launch_ssb routed to
            sweep_chain_kernel);
  feedonly  the feed without the passes: every unit waited for and released,
            no wgmma (what the copies cost);
  tconly    the passes without the feed: wgmma on the slots as they lie, no
            copy issued or waited for (what the tensor cores and A cost);
  unit1     a unit of one K step (16 KB) in a ring of seven, and
  unit2     of two K steps (32 KB) in a ring of three, where the shipped
            one is four K steps (64 KB) in a ring of two;
  twoacc    the big x big pass into an accumulator of its own, added to the
            other two passes' at the product's end (twoaccpbt: in PBT alone);
  onepass   big x big alone (one TF32 pass; the outputs are not the chain's);
  multicast the blocks in clusters of two (two channels at the same unit):
            each unit's copy issued once for the pair, by rank u mod 2, and
            multicast into both blocks' slots (.multicast::cluster), each
            block's empty barrier counting both blocks' releases (remote
            arrives at a mapa address), a cluster barrier at the start and at
            the end (even channel counts only);
  strong    multicast with the feed's barriers at cluster scope: each release
            arrives with release.cluster semantics and each wait acquires at
            cluster scope (the first build's);
  localarrive  multicast with the release to the block's own barrier a local
            arrive.

Beside each time, the operator's bytes a segment that the blocks copy out of
the L2, by count (not measured): the raw fp32 operator for every block and
chunk on the older engines and rawfeed, the image for every block (multicast:
every pair) and chunk on the fed one. The products' share is shipped -
noprod, and about prodonly; the rest's is shipped - prodonly, and about
noprod. Only shipped, rawfeed, unit1, unit2, twoacc, twoaccpbt, multicast,
strong and localarrive compute the chain; the others' errors are printed but
mean nothing. fed also times shipped and multicast at 16, 32 and 64 channels:
a per-SM pace keeps the segment's time, a pace shared over the card (the L2)
drops with the blocks.

    python radiodsp_sdr_rx_tpu_torch/diag/k1_split.py [--variants a,b,...] [ROOT]

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
MODE = sys.argv[1] if sys.argv[1:2] in (["--build"], ["--measure"]) else None
ONLY = sys.argv[2].split(",") if sys.argv[1:2] == ["--variants"] else None
_ROOT_ARG = sys.argv[3 if ONLY else (3 if MODE else 1):]
ROOT = (Path(_ROOT_ARG[0]) if _ROOT_ARG else Path(__file__).parents[2]).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from radiodsp_sdr_rx_tpu_torch.utils import build  # noqa: E402

OUT = build.BUILD_DIR / "k1_split"
CHAIN, TC, CU = "sweep_chain.cuh", "tc_gemm.cuh", "sweep_chain.cu"
# the chunk loop of sweep_chain_kernel: its mix, its AGC and, for each
# engine, its two products (each edit's text occurs once in its file)
_MIX = (CHAIN, "    mix_rows<kNB, BlockSync>(a, cc, Mr, Mi, keep_row, seg, env_c, base, row0, "
               "rows);\n", "")
_AGC = (CHAIN, "    agc_rows<BlockSync>(a, cc, Ab, rows, seg, env_c);\n\n"
               "    // 4. PBT -> [L|R]; the", "\n    // 4. PBT -> [L|R]; the")
_FMA_BAND = (CHAIN, "        float acc[8][4];\n        chunk_gemm<128>(Mr, Mi, a.w_band, 512, As, "
                    "Bs, acc);", "        float acc[8][4] = {};\n        __syncthreads();")
_FMA_PBT = (CHAIN, "    float lr[8][8];\n    chunk_gemm<256>(Ab, Ab, a.w_pbt, 256, As, Bs, lr);\n"
                   "    if (tid < kBlk)",
            "    float lr[8][8] = {};\n    __syncthreads();\n    if (tid < kBlk)")
# the same two products on the tensor cores (the product policy Tf32x3)
_TC_BAND = (CHAIN, "        Tf32x3::Acc<128> acc;\n"
                   "        Tf32x3::gemm<128>(Mr, Mi, a.w_band, 512, As, acc);",
            "        Tf32x3::Acc<128> acc = {};\n        __syncthreads();")
_TC_PBT = (CHAIN, "    std::conditional_t<kTc, Tf32x3::Acc<256>, float[8][8]> lr;\n"
                  "    if constexpr (kTc)\n      Tf32x3::gemm<256>(Ab, Ab, a.w_pbt, 256, As, lr);\n"
                  "    else\n      chunk_gemm<256>(Ab, Ab, a.w_pbt, 256, As, Bs, lr);",
           "    std::conditional_t<kTc, Tf32x3::Acc<256>, float[8][8]> lr = {};\n"
           "    __syncthreads();")
# the fed kernel (ssb_fed_kernel) and its engine (tc_gemm.cuh's Feed, fed_gemm)
_FED_MIX = (CHAIN, "      mix_rows<false, Sync>(a, cc, Mr, Mi, nullptr, seg, env_c, base, row0, "
                   "rows);\n", "")
_FED_AGC = (CHAIN, "      agc_rows<Sync>(a, cc, Ab, rows, seg, env_c);\n\n"
                   "      // 4. PBT -> [L|R] (L alone", "\n      // 4. PBT -> [L|R] (L alone")
_PASSES = (TC, "kKS * kNC);\n    fence();\n    wgmma(acc, as, db);\n    wgmma(acc, ab, ds);\n"
               "    wgmma(acc, ab, db);\n    commit();\n  };",
           "kKS * kNC);\n    (void)db;\n    (void)ds;\n  };")
_NO_WAIT = (TC, "    if (s % feed::kUnitSteps == 0) f.wait(i);\n", "")
_NO_RELEASE = (TC, "    if (s >= 1 && s % feed::kUnitSteps == 0) f.release(i0 + s / feed::kUnitSteps - 1);\n",
               "")
_NO_LAST = (TC, "  wait<0>();\n  f.release(i0 + units - 1);", "  wait<0>();")
# the fed engine's three passes (its descriptors' line makes the text unique)
_PASS3 = ("kKS * kNC);\n    fence();\n    wgmma(acc, as, db);\n    wgmma(acc, ab, ds);\n"
          "    wgmma(acc, ab, db);\n    commit();\n")
_TWOACC = [(TC, _PASS3, "kKS * kNC);\n    fence();\n    wgmma(acc, as, db);\n    wgmma(acc, ab, ds);\n"
                        "    wgmma(acc2, ab, db);\n    commit();\n"),
           (TC, "    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;\n\n  // K step s: its three",
            "    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;\n  float acc2[kNC / 8][4];\n"
            "#pragma unroll\n  for (int j = 0; j < kNC / 8; ++j)\n#pragma unroll\n"
            "    for (int c = 0; c < 4; ++c) acc2[j][c] = 0.f;\n\n  // K step s: its three"),
           (TC, "  wait<0>();\n  f.release(i0 + units - 1);\n  f.next",
            "  wait<0>();\n#pragma unroll\n  for (int j = 0; j < kNC / 8; ++j)\n#pragma unroll\n"
            "    for (int c = 0; c < 4; ++c) acc[j][c] += acc2[j][c];\n"
            "  f.release(i0 + units - 1);\n  f.next")]
_NO_PRODUCE = (TC, "    if (!producer()) return;\n    for (int u = 0; u < total; ++u) {",
               "    return;\n    for (int u = 0; u < total; ++u) {")
_NO_FEED = [_NO_WAIT, _NO_RELEASE, _NO_LAST, _NO_PRODUCE]
_RAWFEED = [(CHAIN, "kDemod == Demod::kSSB && kNB && kNR == Nr::kNone && kEmitR;",
          "kDemod == Demod::kSSB && kNR == Nr::kNone;"),
         (CHAIN, "      Tf32x3::store(lr, a.out_l, a.out_r, base, row0, rows, a.out_gain);",
          "      if constexpr (kEmitR)\n"
          "        Tf32x3::store(lr, a.out_l, a.out_r, base, row0, rows, a.out_gain);\n"
          "      else\n"
          "        tc::store_rows<256, 1>(lr, a.out_l, a.out_r, base, row0, rows, a.out_gain);"),
         (CU, "  return emit_r ? launch_fed<true>(a, f, channels, device, stream)\n"
              "                : launch_fed<false>(a, f, channels, device, stream);",
          "  (void)f;\n  return emit_r ? launch<Demod::kSSB, false, Nr::kNone, true>(a, channels, "
          "device, stream)\n                : launch<Demod::kSSB, false, Nr::kNone, false>(a, "
          "channels, device, stream);")]
_ARRIVE = "    feed::arrive(empty(i % feed::kSlots));"
_END = "    if (tid == 0) a.env_out[c] = env_c[0];\n  }\n}\n"   # ssb_fed_kernel's last lines
_AM_ENTRY = "// The AM chain (nb != 0: with the blanker) on `split` blocks per channel"
# trace: block 0 stamps (clock64, into shared memory) each of units 64-127
# (the second chunk): the chain's warpgroup leaders the wait for the unit
# begun and ended, its passes issued, its release begun and ended; the
# producer the wait for the unit's slot begun and ended and its copy issued;
# read back through read_trace
_STAMP = "if (blockIdx.x == 0 && ({i}) >= 64 && ({i}) < 128) " \
         "tc::s_trace[{w}][({i}) - 64][{k}] = clock64();"
_CHAIN_STAMP = "if ((threadIdx.x & 127) == 0) {{ " + _STAMP.format(i="{i}", w="threadIdx.x >> 7",
                                                                    k="{k}") + " }}"
_FEED = "template <class Plan, int kSlotFloats = feed::kSlotFloats>\nstruct Feed {"
_TRACE = [(TC, _FEED,
           "__device__ long long g_trace[2][64][8];\n__shared__ long long s_trace[2][64][8];\n"
           + _FEED),
          (CHAIN, _END,
           _END[:-2] + "  if (blockIdx.x == 0 && (threadIdx.x & 127) == 0 && threadIdx.x < kThreads)\n"
           "    for (int k = 0; k < 64 * 8; ++k)\n"
           "      tc::g_trace[threadIdx.x >> 7][k / 8][k % 8] = tc::s_trace[threadIdx.x >> 7][k / 8][k % 8];\n"
           "}\n"),
          (TC, "    feed::wait(full(i % feed::kSlots), (uint32_t)(i / feed::kSlots) & 1u);\n  }",
           "    " + _CHAIN_STAMP.format(i="i", k=0) + "\n"
           "    feed::wait(full(i % feed::kSlots), (uint32_t)(i / feed::kSlots) & 1u);\n"
           "    " + _CHAIN_STAMP.format(i="i", k=1) + "\n  }"),
          (TC, "    wgmma(acc, ab, db);\n    commit();\n  };\n  // after K step s is issued: once",
           "    wgmma(acc, ab, db);\n    commit();\n    " + _CHAIN_STAMP.format(i="i0 + s / feed::kUnitSteps", k=2)
           + "\n  };\n  // after K step s is issued: once"),
          (TC, "    if ((threadIdx.x & 127) != 0) return;\n" + _ARRIVE + "\n  }",
           "    if ((threadIdx.x & 127) != 0) return;\n    " + _STAMP.format(i="i", w="threadIdx.x >> 7", k=3)
           + "\n" + _ARRIVE + "\n    " + _STAMP.format(i="i", w="threadIdx.x >> 7", k=4) + "\n  }"),
          (TC, "      if (u >= feed::kSlots) feed::wait(empty(s), (uint32_t)(u / feed::kSlots - 1) & 1u);\n"
               "      feed::expect(full(s), plan.bytes(u));\n"
               "      feed::copy(feed::addr(slot(u)), plan.src(u), plan.bytes(u), full(s));\n",
           "      " + _STAMP.format(i="u", w=0, k=5) + "\n"
           "      if (u >= feed::kSlots) feed::wait(empty(s), (uint32_t)(u / feed::kSlots - 1) & 1u);\n"
           "      " + _STAMP.format(i="u", w=0, k=6) + "\n"
           "      feed::expect(full(s), plan.bytes(u));\n"
           "      feed::copy(feed::addr(slot(u)), plan.src(u), plan.bytes(u), full(s));\n"
           "      " + _STAMP.format(i="u", w=0, k=7) + "\n"),
          (CU, _AM_ENTRY,
           "extern \"C\" int read_trace(long long* out) {\n"
           "  return (int)cudaMemcpyFromSymbol(out, tc::g_trace, sizeof(tc::g_trace));\n}\n\n"
           + _AM_ENTRY)]
# multicast: the pair's helpers in tc_gemm.cuh's namespace feed, the copy
# issued by one rank for both, four releases an empty barrier, the cluster
# barriers and launch (its rank's remote arrive the one edit strong and
# localarrive take up)
_PAIR_ARRIVE = ("    for (unsigned r = 0; r < 2; ++r) "
                "feed::arrive_at(feed::peer(empty(i % feed::kSlots), r));")
_MULTICAST = [
    (TC, "}  // namespace feed",
     "__device__ __forceinline__ uint32_t peer(uint32_t a, unsigned rank) {\n"
     "  uint32_t r;\n"
     "  asm volatile(\"mapa.shared::cluster.u32 %0, %1, %2;\" : \"=r\"(r) : \"r\"(a), \"r\"(rank));\n"
     "  return r;\n}\n"
     "__device__ __forceinline__ unsigned rank() {\n"
     "  unsigned r;\n"
     "  asm volatile(\"mov.u32 %0, %%cluster_ctarank;\" : \"=r\"(r));\n"
     "  return r;\n}\n"
     "__device__ __forceinline__ void cluster_sync() {\n"
     "  asm volatile(\"barrier.cluster.arrive.release;\\n\\tbarrier.cluster.wait.acquire;\" ::: "
     "\"memory\");\n}\n"
     "__device__ __forceinline__ void arrive_at(uint32_t bar) {\n"
     "  asm volatile(\"mbarrier.arrive.shared::cluster.b64 _, [%0];\" ::\"r\"(bar) : \"memory\");\n}\n"
     "__device__ __forceinline__ void mcopy(uint32_t dst, const float* src, uint32_t bytes, "
     "uint32_t bar) {\n"
     "  asm volatile(\n"
     "      \"cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster \"\n"
     "      \"[%0], [%1], %2, [%3], %4;\"\n"
     "      ::\"r\"(dst), \"l\"(src), \"r\"(bytes), \"r\"(bar), \"h\"((uint16_t)3) : \"memory\");\n}\n\n"
     "}  // namespace feed"),
    (TC, "      feed::init(empty(s), 2);", "      feed::init(empty(s), 4);"),
    (TC, "      feed::copy(feed::addr(slot(u)), plan.src(u), plan.bytes(u), full(s));",
     "      if (u % 2 == (int)feed::rank())\n"
     "        feed::mcopy(feed::addr(slot(u)), plan.src(u), plan.bytes(u), full(s));"),
    (TC, _ARRIVE, _PAIR_ARRIVE),
    (CHAIN, "  __syncthreads();            // the ring's barriers set up before any copy or wait",
     "  tc::feed::cluster_sync();   // both blocks' barriers set up before any copy or arrival"),
    (CHAIN, _END, _END[:-2] + "  tc::feed::cluster_sync();   // no block leaves while the other may "
     "still write to it\n}\n"),
    (CHAIN, "  ssb_fed_kernel<kEmitR><<<channels, kThreads + 32, smem, (cudaStream_t)stream>>>(a, f);",
     "  if (channels % 2) return (int)cudaErrorInvalidValue;\n"
     "  cudaLaunchAttribute attr[1];\n"
     "  attr[0].id = cudaLaunchAttributeClusterDimension;\n"
     "  attr[0].val.clusterDim.x = 2;\n"
     "  attr[0].val.clusterDim.y = 1;\n"
     "  attr[0].val.clusterDim.z = 1;\n"
     "  cudaLaunchConfig_t cfg{};\n"
     "  cfg.gridDim = dim3(channels);\n"
     "  cfg.blockDim = dim3(kThreads + 32);\n"
     "  cfg.dynamicSmemBytes = smem;\n"
     "  cfg.stream = (cudaStream_t)stream;\n"
     "  cfg.attrs = attr;\n"
     "  cfg.numAttrs = 1;\n"
     "  err = cudaLaunchKernelEx(&cfg, ssb_fed_kernel<kEmitR>, a, f);\n"
     "  if (err != cudaSuccess) return (int)err;")]
_LOCAL_ARRIVE = (TC, _PAIR_ARRIVE,
                 "    for (unsigned r = 0; r < 2; ++r) {\n      if (r == feed::rank())\n"
                 "        asm volatile(\"mbarrier.arrive.shared::cta.b64 _, [%0];\" "
                 "::\"r\"(empty(i % feed::kSlots)) : \"memory\");\n      else\n"
                 "        feed::arrive_at(feed::peer(empty(i % feed::kSlots), r));\n    }")
EDITS = {
    "fma": {"shipped": [], "noprod": [_FMA_BAND, _FMA_PBT], "prodonly": [_MIX, _AGC]},
    "tf32x3": {"shipped": [], "noprod": [_FMA_BAND, _TC_BAND, _TC_PBT],
               "prodonly": [_MIX, _AGC]},
    "fed": {"shipped": [], "rawfeed": _RAWFEED, "noprod": [_PASSES, *_NO_FEED],
            "prodonly": [_FED_MIX, _FED_AGC], "feedonly": [_PASSES], "tconly": _NO_FEED,
            "unit1": [(TC, "constexpr int kSlots = 2;", "constexpr int kSlots = 7;"),
                      (TC, "constexpr int kUnitSteps = 4;", "constexpr int kUnitSteps = 1;")],
            "unit2": [(TC, "constexpr int kSlots = 2;", "constexpr int kSlots = 3;"),
                      (TC, "constexpr int kUnitSteps = 4;", "constexpr int kUnitSteps = 2;")],
            "twoacc": _TWOACC,
            "twoaccpbt": [(f, o, n.replace("wgmma(acc2, ab, db)", "wgmma(kSplitK ? acc : acc2, ab, db)")
                           .replace("    for (int c = 0; c < 4; ++c) acc[j][c] += acc2[j][c];",
                                    "    for (int c = 0; c < 4; ++c) if (!kSplitK) acc[j][c] += acc2[j][c];"))
                          for f, o, n in _TWOACC],
            "onepass": [(TC, _PASS3, "kKS * kNC);\n    fence();\n    wgmma(acc, ab, db);\n"
                                     "    commit();\n")],
            "multicast": _MULTICAST,
            "strong": [*_MULTICAST,
                       (TC, "mbarrier.arrive.shared::cluster.b64", "mbarrier.arrive.release.cluster."
                            "shared::cluster.b64"),
                       (TC, "mbarrier.try_wait.parity.shared::cta.b64", "mbarrier.try_wait.parity."
                            "acquire.cluster.shared::cta.b64")],
            "localarrive": [*_MULTICAST, _LOCAL_ARRIVE], "trace": _TRACE},
}
KERNELS = {"fma": ("sweep_chain_ssb_nb", "sweep_chain_ssb"),
           "tf32x3": ("sweep_chain_ssb_nb", "sweep_chain_ssb"),
           "fed": ("sweep_chain_ssb", "sweep_chain_ssb_mono")}


def engine():
    if "ssb_fed_kernel" in (build.CSRC / CHAIN).read_text():
        return "fed"
    return "tf32x3" if (build.CSRC / TC).exists() else "fma"


def make(name):
    """csrc/ with the variant's edits, in OUT/name/csrc."""
    csrc = OUT / name / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(build.CSRC, csrc)
    for file, old, new in EDITS[engine()][name]:
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


def l2_bytes(kname, c, n, cluster, fed):
    """The operator's bytes a segment copied out of the L2, by count: every
    `cluster` blocks copy it once a chunk."""
    chunks = -(-n // (128 * 64))
    if not fed:   # every block, every chunk: w_ssb and all of w_pbt as they are
        return c * chunks * 4 * (512 * 128 + 256 * 256)
    mono = kname.endswith("_mono")   # the image: band 512 KB, PBT 512 KB or L's 256 KB a chunk
    return -(-c // cluster) * chunks * 8 * (512 * 128 + 256 * (128 if mono else 256))


def trace(kname, args, image, emit_r):
    """Block 0's feed, unit by unit (the trace variant): medians over units
    64-126 (the second chunk) of each chain warpgroup's cycles waiting for a
    unit, issuing its passes and releasing it, and between two units' waits;
    of the producer's waiting for a slot, expecting and copying, and between
    two units; for the band-pass's units and PBT's apart."""
    import ctypes

    import numpy as np
    from radiodsp_sdr_rx_tpu_torch.ops import sweep
    fn = build.load_library("sweep_chain").read_trace
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    sweep.launch_chain(*args, emit_r=emit_r, image=image)
    torch.cuda.synchronize()
    t = np.zeros((2, 64, 8), np.int64)
    if fn(t.ctypes.data):
        raise RuntimeError("read_trace failed")
    part = []
    u = np.arange(0, 63)
    for what, v in (("band", u[u < 32]), ("pbt", u[u >= 32])):
        for wg in range(2):
            d = [np.median(t[wg, v, k + 1] - t[wg, v, k]) for k in (0, 1, 3)]
            per = np.median(t[wg, v + 1, 0] - t[wg, v, 0])
            part.append(f"{what} warpgroup {wg}: wait {d[0]:.0f}, passes issued {d[1]:.0f}, "
                        f"release {d[2]:.0f}, period {per:.0f}")
        d = [np.median(t[0, v, k + 1] - t[0, v, k]) for k in (5, 6)]
        per = np.median(t[0, v + 1, 5] - t[0, v, 5])
        part.append(f"{what} producer: empty wait {d[0]:.0f}, expect and copy {d[1]:.0f}, "
                    f"period {per:.0f}")
    return f"{kname} cycles a unit: " + "; ".join(part)


def measure(name):
    from radiodsp_sdr_rx_tpu_torch.models.config import AGCMode, DemodMode, ReceiverConfig
    from radiodsp_sdr_rx_tpu_torch.models.fused import FusedSSBBank
    from radiodsp_sdr_rx_tpu_torch.ops import sweep
    use(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    c, n, line, eng = 128, 1 << 19, [], engine()
    g = torch.Generator(device="cuda").manual_seed(0)
    cfg = ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_200_000.0,
                         capture_center_freq=7_190_000.0, agc=AGCMode.MEDIUM)
    freqs = [7_190_000.0 + 1_000.0 * k for k in range(c)]
    for kname in KERNELS[eng]:
        nb, emit_r = kname.endswith("_nb"), not kname.endswith("_mono")
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
        if eng != "fed":
            ms = [time_ms(lambda: sweep.sweep_full_chain(*args)) for _ in range(2)]
            line.append(f"{kname} " + " / ".join(f"{v:.3f}" for v in ms) + " ms, operator "
                        f"{l2_bytes(kname, c, n, 1, False) / 1e9:.2f} GB of L2 reads")
            continue
        image = sweep.ssb_image(args[4], args[5], emit_r)
        if name == "trace":
            line.append(trace(kname, args, image, emit_r))
            continue
        ref = sweep.sweep_full_chain_plain(*args, emit_r=emit_r)

        def run(cargs=args):
            return sweep.launch_chain(*cargs, emit_r=emit_r, image=image)
        got = run()
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref) if a is not None)
        ms = [time_ms(run) for _ in range(2)]
        cluster = 2 if name in ("multicast", "strong", "localarrive") else 1
        l2 = l2_bytes(kname, c, n, cluster, name != "rawfeed")
        line.append(f"{kname} " + " / ".join(f"{v:.3f}" for v in ms)
                    + f" ms (max |kernel - plain| {err:.1e}), operator {l2 / 1e9:.2f} GB of "
                    "L2 reads by count")
        if name in ("shipped", "multicast") and emit_r:
            for cc in (16, 32, 64):   # the same kernel on fewer blocks
                sub = tuple(a[:cc].contiguous() if torch.is_tensor(a) and a.shape[:1] == (c,)
                            else a for a in args)
                line.append(f"{kname} {cc} channels "
                            f"{time_ms(lambda: run(sub)):.3f} ms")
    print(f"{name} ({eng}): " + ", ".join(line), flush=True)


def main():
    if MODE == "--measure":
        return measure(sys.argv[2])
    if MODE == "--build":
        use(sys.argv[2])
        build.load_library("sweep_chain")
        return None
    if not torch.cuda.is_available():
        sys.exit("k1_split: needs a CUDA card")
    print(f"k1_split on {ROOT}, product engine of K1: {engine()}; "
          + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip(), flush=True)
    names = [n for n in EDITS[engine()] if ONLY is None or n in ONLY or n == "shipped"]
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
    names = [n for n in names if not built[n].returncode]
    for name in [*names, "shipped"]:
        subprocess.run([sys.executable, __file__, "--measure", name, str(ROOT)], check=True)
    return None


if __name__ == "__main__":
    main()
