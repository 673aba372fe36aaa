"""What paces the 3xTF32 tensor-core engine (csrc/tc_gemm.cuh) in K2b (pbt)
and K1-nb (sweep_chain_ssb_nb), timed on one CUDA card at the main path's
shape (128 channels x 2^19): the engine as shipped against variants of it,
each csrc/ with lines of tc_gemm.cuh replaced, built into a directory of its
own, held to the plain versions and timed in a process of its own, in turns;
and the rate of mma.sync.m16n8k8 TF32 products on this card with nothing
else to do (a kernel of independent products on registers, built here, at
one to four blocks of 256 threads an SM).

  shipped   as the sources stand: wgmma.mma_async m64nNk8, A from
            registers, three K steps of the operator in shared memory;
  serial    each K step's products finished before the next step's A and
            operator are staged (no overlap of the tensor cores with them);
  intround  small too rounded to TF32 by integer operations, as big is
            ((bits + 2^12) with the low 13 bits cleared: cvt.rna's value for
            every finite x), where the shipped engine takes cvt.rna, which a
            NaN passes through;
  onepass   big x big alone: one TF32 pass (its outputs are not the chain's,
            only its error is printed);
  mma_sync  the engine's first form (diag/tc_gemm_mma_sync.cuh):
            mma.sync.m16n8k8 on fragments loaded by hand, the operator in K
            tiles of 16 rows at a padded stride, warps 2 x 4 over rows and
            columns (K2b alone since the SSB kernels' pre-laid feed, which
            needs wgmma, joined the header);
  nofence   without the proxy fence after each step's staging, and
  nobarrier without the warpgroup's barrier each step: what the per-step
            synchronisation costs (timing only: their outputs may be wrong,
            and the error printed says how far).

Then the pre-laid feed's pieces (probe, below): bulk copies' cycles a copy
and the barrier operations' cycles, which set the feed's unit of four K
steps and its producer warp (csrc/tc_gemm.cuh).

    python -m radiodsp_sdr_rx_tpu_torch.diag.tc_engine [--probe]

(--probe: the pieces alone.)
"""
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from radiodsp_sdr_rx_tpu_torch.utils import build

OUT = build.BUILD_DIR / "tc_engine"
_MMA3 = """descriptor(big + kStep);
    fence();
    wgmma(acc, as, db);
    wgmma(acc, ab, ds);
    wgmma(acc, ab, db);"""
_CVT = """  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;"""
_INT = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
MMA_SYNC = Path(__file__).with_name("tc_gemm_mma_sync.cuh")
EDITS = {   # (old, new) in tc_gemm.cuh; old None: the whole file replaced by new's
    "shipped": [],
    "serial": [("    wait<1>();\n    if (s + 1 < steps) {", "    wait<0>();\n    if (s + 1 < steps) {")],
    "intround": [(_CVT, _INT)],
    "onepass": [(_MMA3, "descriptor(big + kStep);\n    fence();\n    wgmma(acc, ab, db);")],
    "mma_sync": [(None, MMA_SYNC)],   # K2b alone: sweep_chain.cu needs wgmma and the feed
    "nofence": [("      fence_async();\n    }\n    copy_step(s + kRing);",
                 "    }\n    copy_step(s + kRing);")],
    "nobarrier": [("    copy_wait<kRing - 2>();\n    sync_group();\n  };",
                   "    copy_wait<kRing - 2>();\n  };")],
}
PEAK_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(256) mma_peak(float* out, int iters) {
  const uint32_t a0 = __float_as_uint(1.f + threadIdx.x * 1e-3f) & 0xffffe000u;
  const uint32_t b0 = __float_as_uint(1.f - threadIdx.x * 1e-3f) & 0xffffe000u;
  float acc[16][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0, %1, %2, %3}, {%4, %4, %4, %4}, {%5, %5}, {%0, %1, %2, %3};"
                   : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                   : "r"(a0), "r"(b0));
  }
  float s = 0.f;
  for (int j = 0; j < 16; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_peak_launch(float* out, int blocks, int iters) {
  mma_peak<<<blocks, 256>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


# The feed's pieces on this card (csrc/tc_gemm.cuh's pre-laid feed): one
# thread of a block issues bulk copies (cp.async.bulk, complete_tx on an
# mbarrier) of `bytes` from a source every block shares into a ring of
# `inflight` slots, waiting for a slot's copy before refilling it: cycles a
# copy (clock64 over the whole stream) on one block and on a block per SM;
# and the cycles one thread spends on each barrier operation the feed issues
# (the mean over a chain of them, each timed from issue to the next issue).
PROBE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ uint32_t sa(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }
__device__ __forceinline__ void init(uint32_t b, unsigned n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(b), "r"(n) : "memory");
}
__device__ __forceinline__ void expect(uint32_t b, uint32_t n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(n) : "memory");
}
__device__ __forceinline__ void wait(uint32_t b, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}" : "=r"(done) : "r"(b), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void copy(uint32_t dst, const void* src, uint32_t n, uint32_t b) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(dst), "l"(src), "r"(n), "r"(b) : "memory");
}
extern "C" __global__ void bulk_rate(const char* src, long long* out, int units, int bytes,
                                     int inflight) {
  extern __shared__ __align__(128) unsigned char sm[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm);
  unsigned char* ring = sm + 256;
  if (threadIdx.x == 0) {
    for (int s = 0; s < inflight; ++s) init(sa(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const long long t0 = clock64();
    for (int i = 0; i < units; ++i) {
      const int s = i % inflight;
      if (i >= inflight) wait(sa(bars + s), (uint32_t)(i / inflight - 1) & 1u);
      expect(sa(bars + s), bytes);
      copy(sa(ring + (size_t)s * bytes), src + (size_t)(i % 64) * bytes, bytes, sa(bars + s));
    }
    for (int i = units; i < units + inflight; ++i) {
      const int s = i % inflight;
      wait(sa(bars + s), (uint32_t)(i / inflight - 1) & 1u);
    }
    out[blockIdx.x] = clock64() - t0;
  }
}
extern "C" __global__ void barrier_ops(long long* out, int reps) {
  __shared__ uint64_t bar[2];
  if (threadIdx.x != 0) return;
  const uint32_t b0 = sa(bar), b1 = sa(bar + 1);
  init(b0, (1u << 20) - 1);   // never completes a phase within the probe
  init(b1, 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, 0;" : "=r"(remote) : "r"(b0));
  long long t = clock64();
  for (int i = 0; i < reps; ++i)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(b0) : "memory");
  out[0] = clock64() - t;
  t = clock64();
  for (int i = 0; i < reps; ++i)
    asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(remote) : "memory");
  out[1] = clock64() - t;
  t = clock64();
  for (int i = 0; i < reps; ++i)
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(remote) : "memory");
  out[2] = clock64() - t;
  t = clock64();
  for (int i = 0; i < reps; ++i) expect(b0, 16);
  out[3] = clock64() - t;
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(b1) : "memory");
  t = clock64();
  for (int i = 0; i < reps; ++i) wait(b1, 0);
  out[4] = clock64() - t;
}
extern "C" int probe_rate(const char* src, long long* out, int blocks, int units, int bytes,
                          int inflight) {
  const int smem = 256 + inflight * bytes;
  cudaError_t err = cudaFuncSetAttribute(bulk_rate, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bulk_rate<<<blocks, 32, smem>>>(src, out, units, bytes, inflight);
  return (int)cudaGetLastError();
}
extern "C" int probe_ops(long long* out, int reps) {
  barrier_ops<<<1, 32>>>(out, reps);
  return (int)cudaGetLastError();
}
"""
OPS = ("arrive (local)", "arrive (mapa, release.cta)", "arrive (mapa, release.cluster)",
       "arrive.expect_tx", "try_wait on a completed phase")


def probe():
    """The feed's pieces: bulk copies' cycles a copy, barrier operations' cycles."""
    OUT.mkdir(parents=True, exist_ok=True)
    src, so = OUT / "feed_probe.cu", OUT / "libfeed_probe.so"
    src.write_text(PROBE_SRC)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    data = torch.zeros(64 * 32768 // 4, device="cuda")
    out = torch.zeros(sms, dtype=torch.int64, device="cuda")
    units, line = 2048, []
    for blocks in (1, sms):
        for bytes_ in (4096, 8192, 16384, 32768):
            for inflight in (1, 2, 4, 6):
                if inflight * bytes_ > 200_000:
                    continue
                err = lib.probe_rate(ctypes.c_void_p(data.data_ptr()), ctypes.c_void_p(
                    out.data_ptr()), blocks, units, bytes_, inflight)
                torch.cuda.synchronize()
                if err:
                    raise RuntimeError(f"bulk_rate: cudaError {err}")
                cyc = float(out[:blocks].double().mean()) / units
                line.append(f"{blocks} block(s), {bytes_ // 1024} KB, {inflight} in flight: "
                            f"{cyc:.0f} cycles a copy ({bytes_ / cyc:.1f} B a cycle an SM)")
    print("bulk copies (cp.async.bulk, one thread a block, a source all blocks share): "
          + "; ".join(line), flush=True)
    reps = 256
    err = lib.probe_ops(ctypes.c_void_p(out.data_ptr()), reps)
    torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"barrier_ops: cudaError {err}")
    print("barrier operations, cycles each (one thread, a chain of " + str(reps) + "): "
          + ", ".join(f"{k} {float(out[i]) / reps:.1f}" for i, k in enumerate(OPS)), flush=True)


def make(name):
    """csrc/ with the variant's edits, in OUT/name/csrc."""
    import shutil
    csrc = OUT / name / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(build.CSRC, csrc)
    for old, new in EDITS[name]:
        text = (csrc / "tc_gemm.cuh").read_text()
        if old is None:
            (csrc / "tc_gemm.cuh").write_text(new.read_text())
            continue
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: tc_gemm.cuh holds {old!r} {text.count(old)} times")
        (csrc / "tc_gemm.cuh").write_text(text.replace(old, new))


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


def peak():
    """TFLOP/s of TF32 mma.sync products alone, at 1, 2 and 4 blocks an SM."""
    OUT.mkdir(parents=True, exist_ok=True)
    src, so = OUT / "mma_peak.cu", OUT / "libmma_peak.so"
    src.write_text(PEAK_SRC)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out, iters, line = torch.empty(4 * sms * 256, device="cuda"), 4096, []
    for per_sm in (1, 2, 4):
        blocks = per_sm * sms
        ms = time_ms(lambda: lib.mma_peak_launch(ctypes.c_void_p(out.data_ptr()), blocks, iters), 3)
        flops = blocks * 8 * iters * 16 * 2 * 16 * 8 * 8
        line.append(f"{per_sm} block(s) an SM {flops / ms / 1e9:.1f} TFLOP/s")
    print("mma.sync.m16n8k8 TF32 alone: " + ", ".join(line), flush=True)


def measure(name):
    from radiodsp_sdr_rx_tpu_torch.models.config import AGCMode, DemodMode, ReceiverConfig
    from radiodsp_sdr_rx_tpu_torch.models.fused import FusedSSBBank
    from radiodsp_sdr_rx_tpu_torch.ops import staged, sweep
    use(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    c, n = 128, 1 << 19
    g = torch.Generator(device="cuda").manual_seed(0)
    cfg = ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_200_000.0,
                         capture_center_freq=7_190_000.0, agc=AGCMode.MEDIUM)
    freqs = [7_190_000.0 + 1_000.0 * k for k in range(c)]
    bank = FusedSSBBank(cfg, freqs)
    args = (torch.randn((c, n), generator=g, device="cuda"), bank.params.w_pbt,
            torch.randn((c, 128), generator=g, device="cuda"), 0.7)
    err = max(float((a - b).abs().max())
              for a, b in zip(staged.pbt_filter(*args), staged.pbt_filter_plain(*args)))
    line = [f"pbt " + " / ".join(f"{time_ms(lambda: staged.pbt_filter(*args)):.3f}"
                                 for _ in range(2)) + f" ms (max |kernel - plain| {err:.2e})"]
    del args
    if name == "mma_sync":
        print(f"{name}: " + ", ".join(line), flush=True)
        return
    bank = FusedSSBBank(cfg.with_(noise_blanker=True), freqs)
    xr, xi = (torch.randn((c, n), generator=g, device="cuda") * 0.05 for _ in range(2))
    mag = torch.hypot(xr, xi)
    f = (2.2 * mag.mean() / mag.clamp(min=1e-12)).clamp(max=1.0)
    xr, xi = xr * f, xi * f
    for pos in (500, 1733, n // 2 + 7, n - 3, n - 1):
        xr[:, pos] = 8.0
        xi[:, pos] = 8.0
    state = bank.init_state()._replace(nb_avg=torch.full((c,), float(torch.hypot(xr, xi).mean()),
                                                         device="cuda"))
    args = bank.chain_args(xr, xi, state)
    err = max(float((a - b).abs().max())
              for a, b in zip(sweep.sweep_full_chain(*args), sweep.sweep_full_chain_plain(*args)))
    line.append("sweep_chain_ssb_nb " + " / ".join(
        f"{time_ms(lambda: sweep.sweep_full_chain(*args)):.3f}" for _ in range(2))
        + f" ms (max |kernel - plain| {err:.2e})")
    regs = {k: ln for ln in (build.build_log("staged") + build.build_log("sweep_chain")).split(
        "Compiling entry function")[1:] for k in ("pbt_kernel", "DemodE0ELb1ELNS_2NrE0ELb1E")
        if k in ln.split("'")[1]}
    notes = sorted({ln.split("info    :")[-1].strip() for v in regs.values()
                    for ln in v.splitlines() if "wgmma" in ln})
    print(f"{name}: " + ", ".join(line) + "; ptxas " + "; ".join(
        f"{k} " + next(s.strip() for s in v.splitlines() if "registers" in s)
        for k, v in regs.items()) + "".join(f"; {n}" for n in notes), flush=True)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--measure":
        return measure(sys.argv[2])
    if not torch.cuda.is_available():
        sys.exit("tc_engine: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    if sys.argv[1:] == ["--probe"]:
        return probe()
    for name in EDITS:
        make(name)

    def build_variant(name):
        return subprocess.run([sys.executable, "-c", (
            "import sys; from radiodsp_sdr_rx_tpu_torch.diag import tc_engine as e; "
            "from radiodsp_sdr_rx_tpu_torch.utils import build; e.use(sys.argv[1]); "
            "build.load_library('staged'); "
            + ("" if name == "mma_sync" else "build.load_library('sweep_chain')")), name],
            check=True)

    with ThreadPoolExecutor(len(EDITS)) as pool:
        list(pool.map(build_variant, EDITS))
    peak()
    probe()
    for name in [*EDITS, "shipped"]:
        subprocess.run([sys.executable, "-m", "radiodsp_sdr_rx_tpu_torch.diag.tc_engine",
                        "--measure", name], check=True)
    return None


if __name__ == "__main__":
    main()
