// tc_gemm_mma_sync.cuh: the first form of csrc/tc_gemm.cuh, the 3xTF32
// engine on mma.sync.m16n8k8 instead of wgmma, kept for diag/tc_engine.py to
// build and time beside the shipped engine (it has the same interface; no
// kernel of the package includes it).
//
// The contract is chain_common.cuh's chunk_gemm: the A operand A(r, k) is the
// overlap-save frames of two row buffers lo and hi at stride kLd (k in
// [0,128) -> lo[r][k], [128,256) -> lo[r+1][k-128], [256,384) -> hi[r][k-256],
// [384,512) -> hi[r+1][k-384]), the operator w (K, N) row-major in device
// memory, streamed through shared memory in K tiles of kKT rows, fp32
// accumulators in registers, and the call ends at a barrier.
//
// Each fp32 operand x is split into two TF32 values, big = rna(x) and small =
// rna(x - big) (cvt.rna.tf32.f32: round to nearest, ties away from zero; big
// keeps 11 significant bits, big + small 22), and a (x) b is summed as
// small_a b_big + big_a small_b + big_a big_b, each product exact in fp32,
// in mma.sync.m16n8k8 TF32 tensor-core products with fp32 accumulation:
// about 2^-22 relative per term where the TPU kernel's bf16x3 split
// (ops/mxu.py) keeps about 2^-16. The operator is split as it is staged (a K
// tile: 16 rows, kept big and small in shared memory, two tiles, the next
// fetched into registers while the current one is multiplied); A is split as
// its fragments are loaded, straight from the row buffers.
//
// Layout: warp w (of 8) owns chunk rows 32 (w >> 2) + 0..31 and columns
// (w & 3) N/4 + 0..N/4-1, as 2 x N/32 tiles of 16 x 8. Lane (g, t) = (lane
// >> 2, lane & 3) of the warp reads A at rows 4g + 2m and 4g + 2m + 1 for
// m-tile m (its rows g and g + 8): the buffers' stride of 129 floats then puts
// the 32 lanes' A reads on 32 banks (4g + t), and the operator tiles' stride
// of N + 8 floats puts their B reads on 32 banks (8t + g). acc[m][j][c] is
// row 32 (w >> 2) + 4g + 2m + (c >> 1), column (w & 3) N/4 + 8j + 2t + (c & 1).

#pragma once

#include "chain_common.cuh"

namespace {
namespace tc {

constexpr int kKT = 16;                                 // K tile of the operator

template <int N>
__host__ __device__ constexpr int ldb() { return N + 8; }   // operator tile stride
// shared memory of the operator tiles: big and small, two tiles
// (kRing and kSplitK, the shipped engine's ring of operator steps and split
// over K, have no use here)
template <int N, int kRing = 0, bool kSplitK = false>
__host__ __device__ constexpr int tile_floats() { return 4 * kKT * ldb<N>(); }

template <int N, bool kSplitK = false>
using Acc = float[2][N / 32][4];

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// d += a b over one 16 x 8 x 8 tile
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One K tile of the operator: fetched as float4 into registers, stashed split
// into big and small tiles of kKT rows at stride ldb<N>().
template <int N>
struct Tile {
  static constexpr int kV = kKT * N / 4 / kThreads;   // float4 of w per thread
  float4 w[kV];

  __device__ __forceinline__ void fetch(const float4* __restrict__ w4, int t) {
#pragma unroll
    for (int v = 0; v < kV; ++v)
      w[v] = __ldg(w4 + (size_t)t * (kKT * N / 4) + threadIdx.x + v * kThreads);
  }

  __device__ __forceinline__ void stash(float* big, float* small) const {
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int e = threadIdx.x + v * kThreads;
      const int o = e / (N / 4) * ldb<N>() + e % (N / 4) * 4;
      uint4 b, s;
      split(w[v].x, b.x, s.x);
      split(w[v].y, b.y, s.y);
      split(w[v].z, b.z, s.z);
      split(w[v].w, b.w, s.w);
      *reinterpret_cast<uint4*>(big + o) = b;
      *reinterpret_cast<uint4*>(small + o) = s;
    }
  }
};

// acc = A @ w (see the layout above), w (K, N) row-major; the operator tiles
// in tiles[0, tile_floats<N>()). Ends with __syncthreads(), so the caller
// may overwrite what A read.
template <int N, int kRing = 0, bool kSplitK = false>
__device__ __forceinline__ void gemm(const float* lo, const float* hi,
                                     const float* __restrict__ w, int K, float* tiles,
                                     Acc<N>& acc) {
  constexpr int kNT = N / 32, kTile = kKT * ldb<N>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][j][c] = 0.f;

  Tile<N> next;
  next.fetch(w4, 0);
  next.stash(tiles, tiles + kTile);
  __syncthreads();
  const int arow = 32 * (warp >> 2) + 4 * g;        // this lane's first A row
  const int bcol = (warp & 3) * (N / 4) + g;        // its B column in n-tile 0
  const int tiles_k = K / kKT;
  for (int kt = 0; kt < tiles_k; ++kt) {
    const int cur = kt & 1, k0 = kt * kKT;
    if (kt + 1 < tiles_k) next.fetch(w4, kt + 1);
    const float* a = (k0 >= 256 ? hi : lo) + (arow + ((k0 >> 7) & 1)) * kLd + (k0 & 127) + t4;
    const uint32_t* bb = reinterpret_cast<const uint32_t*>(tiles + 2 * cur * kTile) +
                         t4 * ldb<N>() + bcol;
    const uint32_t* bs = bb + kTile;
#pragma unroll
    for (int s = 0; s < kKT; s += 8) {
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* p = a + 2 * m * kLd + s;
        split(p[0], ab[m][0], as[m][0]);          // row g,     col t
        split(p[kLd], ab[m][1], as[m][1]);        // row g + 8, col t
        split(p[4], ab[m][2], as[m][2]);          // row g,     col t + 4
        split(p[kLd + 4], ab[m][3], as[m][3]);    // row g + 8, col t + 4
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int o = s * ldb<N>() + 8 * j;
        const uint32_t b0 = bb[o], b1 = bb[o + 4 * ldb<N>()];
        const uint32_t s0 = bs[o], s1 = bs[o + 4 * ldb<N>()];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma(acc[m][j], as[m], b0, b1);
          mma(acc[m][j], ab[m], s0, s1);
          mma(acc[m][j], ab[m], b0, b1);
        }
      }
    }
    if (kt + 1 < tiles_k) {
      float* nb = tiles + 2 * (cur ^ 1) * kTile;
      next.stash(nb, nb + kTile);
    }
    __syncthreads();
  }
}

// The product's rows into rows 1..kRows of a row buffer (chunk row r -> buffer
// row r + 1), N = 128.
__device__ __forceinline__ void to_rows(const Acc<128>& acc, float* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = 32 * (warp >> 2) + 4 * (lane >> 2) + 1;
  const int c0 = (warp & 3) * 32 + 2 * (lane & 3);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        buf[(r0 + 2 * m + (c >> 1)) * kLd + c0 + 8 * j + (c & 1)] = acc[m][j][c];
}

// Store the product's rows to device memory times `gain`, as chain_common.cuh's
// store_rows: row r of the chunk to out + (row0 + r) * 128 for r < rows,
// columns [0,128) to out_lo and [128,256) to out_hi; kParts = 1 stores only
// the first 128 columns.
template <int N, int kParts = N / 128>
__device__ __forceinline__ void store_rows(const Acc<N>& acc, float* __restrict__ out_lo,
                                           float* __restrict__ out_hi, size_t base, int row0,
                                           int rows, float gain) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = (warp & 3) * (N / 4) + 2 * (lane & 3);   // in n-tile 0
  const int q = col / kBlk;
  if (q >= kParts) return;
  float* out = q ? out_hi : out_lo;
  const int r0 = 32 * (warp >> 2) + 4 * (lane >> 2);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 2 * m + h;
      if (r < rows) {
        float* o = out + base + (size_t)(row0 + r) * kBlk + col % kBlk;
#pragma unroll
        for (int j = 0; j < N / 32; ++j)
          *reinterpret_cast<float2*>(o + 8 * j) =
              make_float2(acc[m][j][2 * h] * gain, acc[m][j][2 * h + 1] * gain);
      }
    }
}

// the shipped engine's cp.async helpers, which staged.cu's pbt_kernel calls
__device__ __forceinline__ void copy4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

}  // namespace tc
}  // namespace
