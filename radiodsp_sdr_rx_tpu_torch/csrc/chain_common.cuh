// chain_common.cuh: device code shared by the receive-chain kernels
// (sweep_chain.cu, staged.cu).
//
// A block of 256 threads works on chunks of 64 rows of 128 samples. Row
// buffers hold 65 rows at a padded stride of 129 floats: row 0 is the row
// before the chunk (the framing carry), rows 1..64 the chunk. chunk_gemm
// multiplies the overlap-save frames of such buffers by an operator held in
// device memory, streamed through shared memory in K tiles of 16 rows,
// double-buffered with a register prefetch of the next tile. mix() is the
// DDS NCO mix at a uint32 phase word, read as int32 before the float
// conversion, with full-accuracy sincosf (no --use_fast_math), as the TPU
// kernels' int32 phase word does.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                         // 8 warps
constexpr int kBlk = 128;                             // samples per row
constexpr int kRows = 64;                             // rows per chunk
constexpr int kLd = kBlk + 1;                         // padded row stride
constexpr int kKT = 16;                               // K tile of the operators
constexpr float kPhaseScale = (float)(6.283185307179586 / 4294967296.0);

constexpr int kAsFloats = 2 * kKT * kRows;            // frame tiles, k-major
constexpr int kBsFloats = 2 * kKT * 256;              // operator tiles
constexpr int kRowBuf = (kRows + 1) * kLd;            // row 0 = carry

static_assert(kRows == 8 * (kThreads / 32), "each warp owns 8 rows of a product");

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

// Store acc rows of a product to device memory as float4, times `gain`:
// row r of the chunk goes to out + (row0 + r) * 128, column 4*lane + 128*q.
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[8][N / 32],
                                           float* __restrict__ out_lo,
                                           float* __restrict__ out_hi,
                                           size_t base, int row0, int rows,
                                           float gain) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = warp * 8 + i;
    if (r < rows) {
      const size_t o = base + (size_t)(row0 + r) * kBlk + lane * 4;
#pragma unroll
      for (int q = 0; q < N / 128; ++q)
        *reinterpret_cast<float4*>((q ? out_hi : out_lo) + o) =
            make_float4(acc[i][4 * q + 0] * gain, acc[i][4 * q + 1] * gain,
                        acc[i][4 * q + 2] * gain, acc[i][4 * q + 3] * gain);
    }
  }
}

}  // namespace
