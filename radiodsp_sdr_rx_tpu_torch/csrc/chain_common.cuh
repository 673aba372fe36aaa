// chain_common.cuh: device code shared by the receive-chain kernels
// (sweep_chain.cu, staged.cu, sweep_spec.cu, sam_wide.cu).
//
// A block of 256 threads works on chunks of 64 rows of 128 samples. Row
// buffers hold 65 rows at a padded stride of 129 floats: row 0 is the row
// before the chunk (the framing carry), rows 1..64 the chunk. chunk_gemm
// multiplies the overlap-save frames of such buffers by an operator held in
// device memory, streamed through shared memory in K tiles of 16 rows,
// double-buffered with a register prefetch of the next tile. scan_segment_carries is the carry step of the chunk scans (the AGC,
// the blanker's average, the DC blocker). mix() is the
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

// The 256 threads that run the products and scans (the chain): their
// barrier, the block they live in, and each thread's index in the chain,
// 0..255, as the products and scans read it (its lane is its thread's):
//   BlockSync  the block of the 256 (K1-K4, K8, K6's SSB and AM routes);
//   ChainSync  a PLL kernel's block of nine warps: the chain on warps 0-7,
//              the walk (walk_ahead below) on warp 8, chain index 256-287;
//   SoloSync   a PLL kernel's block of twelve warps whose walking warp has
//              its scheduler to itself: an SM schedules warp w of a block on
//              its quarter w mod 4, so the walk runs on warp 0, beside only
//              the idle warps 4, 8 (and 11), and the chain's warps 0-7 on
//              warps 1-3, 5-7, 9 and 10 (kSoloMap: nibble w holds warp w's
//              chain index / 32; 288-383 idle). Beside two chain warps the
//              walker's hundred instructions a step take their issue slots;
//              alone, it leaves three chain warps on two quarters instead.
// The PLL kernels' chain meets at barrier 2 (barrier 0 is __syncthreads, 1
// the LMS walk's).
// (tid() keeps threadIdx.x's unsigned type where it is threadIdx.x: the
// index arithmetic's type steers ptxas' register count, and with it how many
// blocks of a kernel share an SM.)
struct BlockSync {
  static constexpr int kBlock = kThreads;
  __device__ __forceinline__ static unsigned tid() { return threadIdx.x; }
  __device__ __forceinline__ static void sync() { __syncthreads(); }
};
struct ChainSync {
  static constexpr int kBlock = kThreads + 32;
  __device__ __forceinline__ static unsigned tid() { return threadIdx.x; }
  __device__ __forceinline__ static void sync() { asm volatile("bar.sync 2, 256;" ::: "memory"); }
};
constexpr unsigned long long kSoloMap = 0xb76a54392108ull;
struct SoloSync {
  static constexpr int kBlock = kThreads + 128;
  __device__ __forceinline__ static int tid() {
    return (int)((kSoloMap >> (4 * (threadIdx.x >> 5))) & 15) * 32 + (threadIdx.x & 31);
  }
  __device__ __forceinline__ static void sync() { asm volatile("bar.sync 2, 256;" ::: "memory"); }
};

// The A operand A(r, k) of a product, r the row of the chunk: the
// overlap-save frames of two row buffers lo and hi whose row 0 is the previous
// chunk's last row: k in [0,128) -> lo[r][k], [128,256) -> lo[r+1][k-128],
// [256,384) -> hi[r][k-256], [384,512) -> hi[r+1][k-384]. With kRPC < kRows
// the chunk's rows are kRows / kRPC channels of kRPC rows each, and each
// channel's rows sit after its own carry row, so chunk row r = g*kRPC + i
// reads buffer rows r + g and r + g + 1 (sam_wide.cu's layout).
template <int N, int kRPC = kRows, class Sync = BlockSync>
struct Tile {
  static constexpr int BV = kKT * N / 4 / kThreads;   // float4 of W per thread
  static constexpr int AV = kKT * kRows / kThreads;   // A values per thread
  float4 b[BV];
  float a[AV];

  __device__ __forceinline__ void fetch(const float* lo, const float* hi,
                                        const float4* __restrict__ w4, int t) {
    const int tid = Sync::tid();
    const int k0 = t * kKT;
    const float* src = (k0 >= 256) ? hi : lo;
    const int r = tid % kRows;
    const int row = r + (kRPC < kRows ? r / kRPC : 0) + ((k0 >> 7) & 1);
    const int col = (k0 & 127) + tid / kRows;
#pragma unroll
    for (int v = 0; v < AV; ++v) a[v] = src[row * kLd + col + 4 * v];
#pragma unroll
    for (int v = 0; v < BV; ++v)
      b[v] = __ldg(w4 + (size_t)t * (kKT * N / 4) + tid + v * kThreads);
  }

  __device__ __forceinline__ void stash(float* as, float* bs) const {
    const int tid = Sync::tid();
#pragma unroll
    for (int v = 0; v < AV; ++v) as[(tid / kRows + 4 * v) * kRows + tid % kRows] = a[v];
#pragma unroll
    for (int v = 0; v < BV; ++v) reinterpret_cast<float4*>(bs)[tid + v * kThreads] = b[v];
  }
};

// acc[i][4q+j] = sum_k A(8*warp+i, k) * w[k][128q + 4*lane + j], fp32 FMA,
// the operator streamed in K tiles of kKT rows through As and Bs (two tiles
// each). Ends with Sync::sync(), so the caller may overwrite what A read.
template <int N, int kRPC = kRows, class Sync = BlockSync>
__device__ __forceinline__ void chunk_gemm(const float* lo, const float* hi,
                                           const float* __restrict__ w, int K,
                                           float* As, float* Bs,
                                           float (&acc)[8][N / 32]) {
  const int lane = Sync::tid() & 31, warp = Sync::tid() >> 5;
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < N / 32; ++j) acc[i][j] = 0.f;

  Tile<N, kRPC, Sync> next;
  next.fetch(lo, hi, w4, 0);
  next.stash(As, Bs);
  Sync::sync();
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
    Sync::sync();
  }
}

// The PLL kernels' pipeline (sweep_chain.cuh's sam_chain_kernel, sam_wide.cu)
// over `chunks` chunks: the walking warp (chain index 256-287) walks chunk k
// while the chain runs chunk k-1's back (the chain after the PLL) and then
// chunk k+1's front (the chain before it), one __syncthreads a chunk; front
// and back meet at Sync::sync(), walk never waits inside a chunk. Chunk k
// lives in slot k & 1: front(k+1) refills the slot back(k-1) has just left.
// walk is called on every thread past the chain (the idle warps too).
template <class Sync, class Front, class Walk, class Back>
__device__ __forceinline__ void walk_ahead(int chunks, Front front, Walk walk, Back back) {
  const bool chain = (int)Sync::tid() < kThreads;
  if (chain) front(0);
  __syncthreads();
  for (int k = 0; k <= chunks; ++k) {
    if (chain) {
      if (k > 0) back(k - 1);
      if (k + 1 < chunks) front(k + 1);
    } else if (k < chunks) {
      walk(k);
    }
    __syncthreads();
  }
}

constexpr int kSegLen = kRows * kBlk / kThreads;      // scan segment: 32 samples
constexpr int kSegsPerRow = kBlk / kSegLen;           // 4
constexpr int kSegsPerLane = kThreads / 32;           // 8 segments per lane of warp 0

static_assert(kSegsPerRow * kSegLen == kBlk, "segments tile a row");

// Warp 0 turns the 256 segment ends of a chunk scan (each from a zero start)
// into the value carried INTO each segment, given c0 carried into the chunk.
// kSum: the decaying sum y = x + y*f (the blanker's average); else the
// decaying max y = max(x, y*f) (the AGC). f_seg decays over one segment,
// f_lanes[i] over 2^i lanes of 8 segments each.
template <bool kSum>
__device__ __forceinline__ void scan_segment_carries(float* seg, float c0,
                                                     float f_seg,
                                                     const float (&f_lanes)[5]) {
  const int lane = threadIdx.x & 31;
  auto comb = [](float x, float y) { return kSum ? x + y : fmaxf(x, y); };
  // lane owns segments 8*lane..8*lane+7; the chunk's carry folds into lane 0
  float y = 0.f;
  for (int i = 0; i < kSegsPerLane; ++i) y = comb(seg[lane * kSegsPerLane + i], y * f_seg);
  if (lane == 0) y = comb(y, c0 * f_lanes[0]);
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float o = __shfl_up_sync(0xffffffffu, y, 1 << i);
    if (lane >= (1 << i)) y = comb(y, o * f_lanes[i]);
  }
  float carry = __shfl_up_sync(0xffffffffu, y, 1);
  if (lane == 0) carry = c0;
  for (int i = 0; i < kSegsPerLane; ++i) {
    const float end = seg[lane * kSegsPerLane + i];
    seg[lane * kSegsPerLane + i] = carry;
    carry = comb(end, carry * f_seg);
  }
}

// decay factors of a scan with per-sample factor p: one segment, 2^i lanes
__device__ __forceinline__ float seg_factors(double p, float (&lanes)[5]) {
#pragma unroll
  for (int i = 0; i < 5; ++i)
    lanes[i] = (float)pow(p, (double)(kSegLen * kSegsPerLane << i));
  return (float)pow(p, (double)kSegLen);
}

// kNear: the angle's range, [-pi, pi], told to the compiler, so that sincosf's
// branch into its reduction for |angle| >= 105615 drops out (the same
// operations on every angle it takes) and the mixes of a thread's samples
// can interleave (staged.cu's mix_item)
template <bool kNear = false>
__device__ __forceinline__ void mix(float x, float y, uint32_t phase, float g_i,
                                    float g_q, float& out_r, float& out_i) {
  float s, c;
  const float angle = (float)(int32_t)phase * kPhaseScale;
  if constexpr (kNear) __builtin_assume(!(fabsf(angle) >= 105615.f));
  sincosf(angle, &s, &c);
  x *= g_i;
  y *= g_q;
  out_r = x * c + y * s;
  out_i = y * c - x * s;
}

// Store acc rows of a product to device memory as float4, times `gain`:
// row r of the chunk goes to out + (row0 + r) * 128, column 4*lane + 128*q,
// for the first kParts 128-column parts q.
template <int N, int kParts = N / 128, class Sync = BlockSync>
__device__ __forceinline__ void store_rows(const float (&acc)[8][N / 32],
                                           float* __restrict__ out_lo,
                                           float* __restrict__ out_hi,
                                           size_t base, int row0, int rows,
                                           float gain) {
  const int lane = Sync::tid() & 31, warp = Sync::tid() >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = warp * 8 + i;
    if (r < rows) {
      const size_t o = base + (size_t)(row0 + r) * kBlk + lane * 4;
#pragma unroll
      for (int q = 0; q < kParts; ++q)
        *reinterpret_cast<float4*>((q ? out_hi : out_lo) + o) =
            make_float4(acc[i][4 * q + 0] * gain, acc[i][4 * q + 1] * gain,
                        acc[i][4 * q + 2] * gain, acc[i][4 * q + 3] * gain);
    }
  }
}

}  // namespace
