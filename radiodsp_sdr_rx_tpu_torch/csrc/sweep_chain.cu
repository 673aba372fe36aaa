// sweep_chain.cu: the whole SSB receive chain of one channel per thread block.
//
// Replaces _chain_kernel with demod="ssb", nb=False
// (radiodsp_sdr_rx_tpu/ops/pallas_sweep.py:261, wrapper sweep_full_chain :628).
// Per sample: input gain / IQ balance, DDS NCO mix, overlap-save band-pass +
// SSB demod as frames(rows,512) @ w_ssb(512,128), AGC
// env[k] = max(|a[k]|, env[k-1]*release), gain = min(target/max(env,1e-12),
// max_gain), PBT frames(rows,256) @ w_pbt(256,256) -> [L|R], output gain.
//
// What bounds it on an H100: per IQ sample it reads 8 B and writes 8 B, and
// does 2,048 flops (1,024 for each of the two products per 128 samples). One
// 128-channel x 2^19-sample segment is 1.07 GB (0.32 ms at 3.35 TB/s) and
// 137 GFLOP (2.0 ms at the 67 TFLOP/s fp32 rate outside the tensor cores):
// in fp32 SIMT it is bound by arithmetic.
//
// What the design does about it: every intermediate stays on chip, so device
// memory sees only the 16 B/sample; the time goes to the two products, run
// as register-blocked fp32 FMA (8 rows x 4 or 8 columns per thread, the
// frame operand broadcast from shared memory). One block of 256 threads owns
// one channel (128 blocks for 132 SMs) and walks time in chunks of 64 rows
// of 128 samples, which is what the TPU grid did with its sequential axis.
// The framing tail, the PBT tail and the AGC envelope stay in shared memory
// from chunk to chunk. Neither operator fits in shared memory (256 KiB each):
// both are streamed from L2 through shared memory in K tiles of 16 rows,
// double-buffered with a register prefetch of the next tile, and re-read
// once per chunk (512 KiB of L2 traffic per 8.4 MFMA). The AGC scan runs as
// 256 segments of 32 samples: each thread scans its segment, warp 0 scans the
// segment ends (a decaying max, release^32 per segment), and each thread
// re-runs its segment from the true carry, so every sample follows the
// sequential recurrence. The DDS phase is phase0 + pos*inc in uint32,
// read as int32 before the float conversion, and sincosf runs at full
// accuracy (no --use_fast_math), as the TPU kernel's int32 phase word does.
// A TF32/3xTF32 tensor-core design of the two products is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                         // 8 warps
constexpr int kBlk = 128;                             // samples per row
constexpr int kRows = 64;                             // rows per chunk
constexpr int kLd = kBlk + 1;                         // padded row stride
constexpr int kKT = 16;                               // K tile of the operators
constexpr int kSegLen = kRows * kBlk / kThreads;      // AGC segment: 32 samples
constexpr int kSegsPerRow = kBlk / kSegLen;           // 4
constexpr int kSegsPerLane = kThreads / 32;           // 8 segments per lane of warp 0
constexpr float kPhaseScale = (float)(6.283185307179586 / 4294967296.0);

constexpr int kAsFloats = 2 * kKT * kRows;            // frame tiles, k-major
constexpr int kBsFloats = 2 * kKT * 256;              // operator tiles
constexpr int kRowBuf = (kRows + 1) * kLd;            // row 0 = carry
constexpr int kSmemFloats = kAsFloats + kBsFloats + 3 * kRowBuf + kThreads + 4;

static_assert(kRows == 8 * (kThreads / 32), "each warp owns 8 rows of a product");
static_assert(kSegsPerRow * kSegLen == kBlk, "segments tile a row");

// Frame operand A(r, k) of a product, with r the row of the chunk:
// k in [0,128) -> lo[r][k], [128,256) -> lo[r+1][k-128],
// [256,384) -> hi[r][k-256], [384,512) -> hi[r+1][k-384].
// lo/hi are row buffers whose row 0 is the previous chunk's last row.
template <int N>
struct Tile {
  static constexpr int BV = kKT * N / 4 / kThreads;   // float4 of W per thread
  static constexpr int AV = kKT * kRows / kThreads;   // A values per thread
  float4 b[BV];
  float a[AV];

  __device__ __forceinline__ void fetch(const float* lo, const float* hi,
                                        const float4* __restrict__ w4, int t) {
    const int tid = threadIdx.x;
    const int k0 = t * kKT;
    const float* src = (k0 >= 256) ? hi : lo;
    const int row = tid % kRows + ((k0 >> 7) & 1);
    const int col = (k0 & 127) + tid / kRows;
#pragma unroll
    for (int v = 0; v < AV; ++v) a[v] = src[row * kLd + col + 4 * v];
#pragma unroll
    for (int v = 0; v < BV; ++v)
      b[v] = __ldg(w4 + (size_t)t * (kKT * N / 4) + tid + v * kThreads);
  }

  __device__ __forceinline__ void stash(float* as, float* bs) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int v = 0; v < AV; ++v) as[(tid / kRows + 4 * v) * kRows + tid % kRows] = a[v];
#pragma unroll
    for (int v = 0; v < BV; ++v) reinterpret_cast<float4*>(bs)[tid + v * kThreads] = b[v];
  }
};

// acc[i][4q+j] = sum_k A(8*warp+i, k) * w[k][128q + 4*lane + j], fp32 FMA.
// Ends with __syncthreads(), so the caller may overwrite what A read.
template <int N>
__device__ __forceinline__ void chunk_gemm(const float* lo, const float* hi,
                                           const float* __restrict__ w, int K,
                                           float* As, float* Bs,
                                           float (&acc)[8][N / 32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < N / 32; ++j) acc[i][j] = 0.f;

  Tile<N> next;
  next.fetch(lo, hi, w4, 0);
  next.stash(As, Bs);
  __syncthreads();
  const int tiles = K / kKT;
  for (int t = 0; t < tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < tiles) next.fetch(lo, hi, w4, t + 1);
    const float* as = As + cur * kKT * kRows + warp * 8;
    const float* bs = Bs + cur * kKT * 256 + lane * 4;
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kRows);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * kRows + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int q = 0; q < N / 128; ++q) {
        const float4 b = *reinterpret_cast<const float4*>(bs + kk * N + q * 128);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][4 * q + 0] = fmaf(a[i], b.x, acc[i][4 * q + 0]);
          acc[i][4 * q + 1] = fmaf(a[i], b.y, acc[i][4 * q + 1]);
          acc[i][4 * q + 2] = fmaf(a[i], b.z, acc[i][4 * q + 2]);
          acc[i][4 * q + 3] = fmaf(a[i], b.w, acc[i][4 * q + 3]);
        }
      }
    }
    if (t + 1 < tiles) next.stash(As + (cur ^ 1) * kKT * kRows, Bs + (cur ^ 1) * kKT * 256);
    __syncthreads();
  }
}

__device__ __forceinline__ void mix(float x, float y, uint32_t phase, float g_i,
                                    float g_q, float& out_r, float& out_i) {
  float s, c;
  sincosf((float)(int32_t)phase * kPhaseScale, &s, &c);
  x *= g_i;
  y *= g_q;
  out_r = x * c + y * s;
  out_i = y * c - x * s;
}

__global__ void __launch_bounds__(kThreads, 1) sweep_chain_ssb_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const long long* __restrict__ inc, const long long* __restrict__ phase0,
    const float* __restrict__ w_ssb, const float* __restrict__ w_pbt,
    const float* __restrict__ tail_r, const float* __restrict__ tail_i,
    const float* __restrict__ atail_in, const float* __restrict__ env0,
    float* __restrict__ out_l, float* __restrict__ out_r,
    float* __restrict__ atail_out, float* __restrict__ env_out, int n,
    double release, float target, float max_gain, int agc_enabled,
    float out_gain, float g_i, float g_q) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = As + kAsFloats;
  float* Mr = Bs + kBsFloats;  // mixed I rows
  float* Mi = Mr + kRowBuf;    // mixed Q rows
  float* Ab = Mi + kRowBuf;    // demodulated audio rows, AGC applied in place
  float* seg = Ab + kRowBuf;   // AGC segment ends, then carries into segments
  float* env_c = seg + kThreads;

  const int c = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)c * n;
  const uint32_t ph0 = (uint32_t)phase0[c];
  const uint32_t dph = (uint32_t)inc[c];
  const float rel = (float)release;
  const float rel_seg = (float)pow(release, (double)kSegLen);
  float rel_lanes[5];  // release^(256 * 2^i): decay across 2^i lanes of warp 0
#pragma unroll
  for (int i = 0; i < 5; ++i)
    rel_lanes[i] = (float)pow(release, (double)(kSegLen * kSegsPerLane << i));

  // the carried raw tail, re-scaled and re-mixed at positions -128..-1
  if (tid < kBlk) {
    const size_t t = (size_t)c * kBlk + tid;
    mix(tail_r[t], tail_i[t], ph0 + (uint32_t)(tid - kBlk) * dph, g_i, g_q,
        Mr[tid], Mi[tid]);
    Ab[tid] = atail_in[t];
  }
  if (tid == 0) env_c[0] = env0[c];

  const int nrows = n / kBlk;
  for (int row0 = 0; row0 < nrows; row0 += kRows) {
    const int rows = min(kRows, nrows - row0);

    // 1. scale + mix into rows 1..kRows (zeros past the end of the segment)
#pragma unroll 4
    for (int e = tid; e < kRows * kBlk; e += kThreads) {
      const int r = e / kBlk, j = e % kBlk;
      float vr = 0.f, vi = 0.f;
      if (r < rows) {
        const int pos = (row0 + r) * kBlk + j;
        mix(xr[base + pos], xi[base + pos], ph0 + (uint32_t)pos * dph, g_i, g_q, vr, vi);
      }
      Mr[(r + 1) * kLd + j] = vr;
      Mi[(r + 1) * kLd + j] = vi;
    }
    __syncthreads();

    // 2. band-pass + SSB demod: Ab rows 1..kRows
    {
      float acc[8][4];
      chunk_gemm<128>(Mr, Mi, w_ssb, 512, As, Bs, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Ab[(warp * 8 + i + 1) * kLd + lane * 4 + j] = acc[i][j];
    }
    __syncthreads();

    // 3. AGC. Segment s = 4*row + quarter; segments past the end come after
    // every valid one, so they never reach a valid carry.
    {
      const int r = tid % kRows, quarter = tid / kRows;
      const int s = r * kSegsPerRow + quarter;
      float* a = Ab + (r + 1) * kLd + quarter * kSegLen;
      float e = 0.f;
      for (int k = 0; k < kSegLen; ++k) e = fmaxf(fabsf(a[k]), e * rel);
      seg[s] = e;
      __syncthreads();
      if (warp == 0) {
        // lane owns segments 8*lane..8*lane+7; the chunk's carry folds into lane 0
        const float c0 = env_c[0];
        float y = 0.f;
        for (int i = 0; i < kSegsPerLane; ++i) y = fmaxf(seg[lane * kSegsPerLane + i], y * rel_seg);
        if (lane == 0) y = fmaxf(y, c0 * rel_lanes[0]);
#pragma unroll
        for (int i = 0; i < 5; ++i) {
          const float o = __shfl_up_sync(0xffffffffu, y, 1 << i);
          if (lane >= (1 << i)) y = fmaxf(y, o * rel_lanes[i]);
        }
        float carry = __shfl_up_sync(0xffffffffu, y, 1);
        if (lane == 0) carry = c0;
        for (int i = 0; i < kSegsPerLane; ++i) {
          const float end = seg[lane * kSegsPerLane + i];
          seg[lane * kSegsPerLane + i] = carry;
          carry = fmaxf(end, carry * rel_seg);
        }
      }
      __syncthreads();
      e = seg[s];
      for (int k = 0; k < kSegLen; ++k) {
        const float v = a[k];
        e = fmaxf(fabsf(v), e * rel);
        if (agc_enabled) a[k] = v * fminf(target / fmaxf(e, 1e-12f), max_gain);
      }
      if (s == rows * kSegsPerRow - 1) env_c[0] = e;
    }
    __syncthreads();

    // 4. PBT -> [L|R], output gain, straight to device memory
    {
      float acc[8][8];
      chunk_gemm<256>(Ab, Ab, w_pbt, 256, As, Bs, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = warp * 8 + i;
        if (r < rows) {
          const size_t o = base + (size_t)(row0 + r) * kBlk + lane * 4;
          *reinterpret_cast<float4*>(out_l + o) =
              make_float4(acc[i][0] * out_gain, acc[i][1] * out_gain,
                          acc[i][2] * out_gain, acc[i][3] * out_gain);
          *reinterpret_cast<float4*>(out_r + o) =
              make_float4(acc[i][4] * out_gain, acc[i][5] * out_gain,
                          acc[i][6] * out_gain, acc[i][7] * out_gain);
        }
      }
    }

    // 5. this chunk's last row becomes the next chunk's row 0
    if (tid < kBlk) {
      Mr[tid] = Mr[rows * kLd + tid];
      Mi[tid] = Mi[rows * kLd + tid];
      Ab[tid] = Ab[rows * kLd + tid];
    }
    __syncthreads();
  }
  if (tid < kBlk) atail_out[(size_t)c * kBlk + tid] = Ab[tid];
  if (tid == 0) env_out[c] = env_c[0];
}

}  // namespace

// Launch on `stream` of CUDA device `device`; returns the cudaError_t of the
// launch (0 on success). Pointers are device pointers to contiguous tensors.
extern "C" int sweep_chain_ssb(
    const float* xr, const float* xi, const long long* inc,
    const long long* phase0, const float* w_ssb, const float* w_pbt,
    const float* tail_r, const float* tail_i, const float* atail_in,
    const float* env0, float* out_l, float* out_r, float* atail_out,
    float* env_out, int channels, int n, int device, double release,
    float target, float max_gain, int agc_enabled, float out_gain, float g_i,
    float g_q, void* stream) {
  const int smem = kSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sweep_chain_ssb_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  sweep_chain_ssb_kernel<<<channels, kThreads, smem, (cudaStream_t)stream>>>(
      xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i, atail_in, env0, out_l,
      out_r, atail_out, env_out, n, release, target, max_gain, agc_enabled,
      out_gain, g_i, g_q);
  return (int)cudaGetLastError();
}
