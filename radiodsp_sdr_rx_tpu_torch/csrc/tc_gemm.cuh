// tc_gemm.cuh: the chain kernels' product as 3xTF32 on the tensor cores,
// with two feeds of the operator into shared memory:
//   gemm      the operator as it is in device memory, copied a K step at a
//             time by every thread (cp.async) and split through registers
//             into the stages wgmma reads (K2b's pbt_kernel in staged.cu;
//             K1-nb's products in sweep_chain.cuh, through its product
//             policy Tf32x3);
//   fed_gemm  the operator split and laid out once outside the kernel (its
//             image, ops/tf32x3.tf32_image), each K step brought into the
//             stage wgmma reads by one bulk copy of a producer warp (K1-ssb
//             and K1-mono, ssb_fed_kernel in sweep_chain.cuh; K2a and K8,
//             mix_demod_kernel in staged.cu; the second half of this file).
// Both run the same algebra and layouts, described here for gemm.
//
// The contract is chain_common.cuh's chunk_gemm: the A operand A(r, k) is the
// overlap-save frames of two row buffers lo and hi at stride kLd (k in
// [0,128) -> lo[r][k], [128,256) -> lo[r+1][k-128], [256,384) -> hi[r][k-256],
// [384,512) -> hi[r+1][k-384]), the operator w (K, N) row-major in device
// memory, streamed through shared memory a K step of 8 rows at a time, fp32
// accumulators in registers, and the call ends at a barrier.
//
// Each fp32 operand x is split into two TF32 values, big = rna(x) and small =
// rna(x - big) (cvt.rna.tf32.f32: round to nearest, ties away from zero; big
// keeps 11 significant bits, big + small 22), and a (x) b is summed as
// small_a big_b + big_a small_b + big_a big_b, each product exact in fp32,
// in three warpgroup products (wgmma.mma_async m64nNk8 TF32, fp32
// accumulation) a K step: about 2^-22 relative per term where the TPU
// kernel's bf16x3 split (ops/mxu.py) keeps about 2^-16.
//
// Layout: the block's two warpgroups each own the chunk's 64 rows and half of
// the N columns (N = 256: wgmma m64n128k8), or, for N = 128, all N columns
// and half of the K steps (kSplitK: m64n128k8 again, where half the columns
// would give m64n64k8, which runs the tensor cores at a lower rate), the two
// parts added at the end; wgmma's accumulators in registers. A comes from registers:
// each lane loads its fragments straight from the row buffers and splits
// them. wgmma's fragment rows are permuted: warp w of a warpgroup holds chunk
// rows 32 (w >> 1) + 4g + 2 (w & 1) + h (lane g = lane >> 2, t = lane & 3; h =
// 0 for fragment row g, 1 for g + 8), so that the row buffers' stride of 129
// floats puts a warp's 32 A reads on 32 banks (4g + t). The operator comes a
// K step of 8 rows at a time, each warpgroup taking its own columns: copied
// as it is (cp.async) into a ring of kRing slots, kRing - 1 steps ahead of
// its staging, then staged split, big and small, in wgmma's K-major layout
// without a swizzle (8 x 16-byte core matrices: column n, k = 4q..4q+3 at
// byte 16 (n % 8) + 128 q + 256 (n / 8)) in one of three stages: while the
// tensor cores run step s, the warpgroup takes step s + 1's A fragments and
// stages its operator into the stage step s - 2 has left, one barrier of the
// warpgroup's four warps a step.
// acc[j][c] is chunk row
// 32 (w >> 1) + 4g + 2 (w & 1) + (c >> 1), column 8j + 2t + (c & 1), plus
// (N / 2) (warp >> 2) without kSplitK.

#pragma once

#include "chain_common.cuh"

namespace {
namespace tc {

constexpr int kKS = 8;       // K step of the operator
constexpr int kStages = 3;   // steps staged split for the tensor cores

// shared memory of the operator's steps: kStages staged split (big and
// small), then a ring of kRing copies as they are (kRing - 2 steps between a
// copy and the wait for it); with kSplitK one such region for each warpgroup
template <int N, int kRing, bool kSplitK>
__host__ __device__ constexpr int tile_floats() {
  return (kSplitK ? 2 : 1) * (2 * kStages + kRing) * kKS * N;
}

// the warpgroup's accumulators: all N columns with kSplitK, else half of them
template <int N, bool kSplitK>
using Acc = float[(kSplitK ? N : N / 2) / 8][4];

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// big is x's bits plus half a TF32 unit, the low 13 bits cleared: cvt.rna's
// value for every finite x and the infinities in two integer operations
// (cvt.rna takes four); a NaN x may give a number there, but small is then
// NaN, so the product is NaN as it should be
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = tf32(x - __uint_as_float(big));
}

// d += a b over the warpgroup's 64 x N/2 tile and one K step; b in shared
// memory, described by its wgmma descriptor
__device__ __forceinline__ void wgmma(float (&d)[8][4], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[16][4], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// the wgmma descriptor of a K step of n columns at s in shared memory, in the
// layout above: core matrices 128 bytes apart along K, 256 along N
__device__ __forceinline__ uint64_t descriptor(const float* s) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(s);
  return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}
// the block's stores to shared memory, seen by the tensor cores' reads
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// cp.async: 16 bytes from device memory into shared memory, or 4 with
// src_bytes 0 or 4 (0: zeros); the groups the issuing thread waits for
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
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

// The warpgroup's kNC columns from col0 of the operator's K step u (8 rows of
// w, contiguous) copied as they are into ring slot `raw` (cp.async, kRing
// steps ahead of their use), and from there stashed split, big and small,
// in wgmma's K-major layout: thread i of the warpgroup takes column n's k =
// 4q..4q+3 for its 16-byte chunks e = i + 128 v (n = col0 + e % kNC, q = e /
// kNC).
template <int N, int kNC>
__device__ __forceinline__ void fetch(float* raw, const float* __restrict__ w, int u, int col0) {
#pragma unroll
  for (int v = 0; v < kNC / 64; ++v) {
    const int e = (threadIdx.x & 127) + v * 128;
    const int o = e / (kNC / 4) * N + col0 + 4 * (e % (kNC / 4));
    copy16(raw + o, w + (size_t)u * kKS * N + o);
  }
}

template <int N, int kNC>
__device__ __forceinline__ void stash(const float* raw, float* big, float* small, int col0) {
#pragma unroll
  for (int v = 0; v < kNC / 64; ++v) {
    const int e = (threadIdx.x & 127) + v * 128, n = col0 + e % kNC, q = e / kNC;
    const int o = 4 * (n % 8) + 32 * q + 64 * (n / 8);
    uint4 b, s;
    split(raw[(4 * q + 0) * N + n], b.x, s.x);
    split(raw[(4 * q + 1) * N + n], b.y, s.y);
    split(raw[(4 * q + 2) * N + n], b.z, s.z);
    split(raw[(4 * q + 3) * N + n], b.w, s.w);
    *reinterpret_cast<uint4*>(big + o) = b;
    *reinterpret_cast<uint4*>(small + o) = s;
  }
}

// the warpgroup's own barrier (named barriers 6 and 7)
__device__ __forceinline__ void sync_group() {
  if (threadIdx.x < 128)
    asm volatile("bar.sync 6, 128;" ::: "memory");
  else
    asm volatile("bar.sync 7, 128;" ::: "memory");
}

// acc = A @ w (see the layout above), w (K, N) row-major; the operator's
// steps in tiles[0, tile_floats<N, kRing, kSplitK>()). Warpgroup wg takes
// columns (N / 2) wg.. of every K step, or with kSplitK every column of K
// steps (K / 16) wg.. (acc is then its part of the sum; to_rows adds the
// two); K / 16 (kSplitK: K / 32) K steps a multiple of 2. Each warpgroup
// copies, stages and multiplies its own part, in a pipeline of its own that
// meets the other's only at the start and the end. The thread may have no
// cp.async group pending. Ends with __syncthreads(), so the caller may
// overwrite what A read and the tiles.
template <int N, int kRing, bool kSplitK>
__device__ __forceinline__ void gemm(const float* lo, const float* hi,
                                     const float* __restrict__ w, int K, float* tiles,
                                     Acc<N, kSplitK>& acc) {
  constexpr int kNC = kSplitK ? N : N / 2;           // the warpgroup's columns
  constexpr int kStep = kKS * N;                     // floats of a step, or of one split half
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wq = warp & 3, wg = warp >> 2;
  float* stages = tiles + (kSplitK ? wg * (2 * kStages + kRing) * kStep : 0);
  float* ring = stages + 2 * kStages * kStep;
  const int arow = 32 * (wq >> 1) + 4 * (lane >> 2) + 2 * (wq & 1);   // fragment row g
  const int acol = lane & 3;
  const int col0 = kSplitK ? 0 : wg * kNC;           // the warpgroup's first column
  const int steps = K / kKS / (kSplitK ? 2 : 1);     // the warpgroup's K steps
  const int step0 = kSplitK ? wg * steps : 0;        // its first
#pragma unroll
  for (int j = 0; j < kNC / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  // A's fragments of K step k, split: rows arow (+1), columns k + t (+4)
  auto load_a = [&](int k, uint32_t (&ab)[4], uint32_t (&as)[4]) {
    const float* p = (k >= 256 ? hi : lo) + (arow + ((k >> 7) & 1)) * kLd + (k & 127) + acol;
    split(p[0], ab[0], as[0]);
    split(p[kLd], ab[1], as[1]);
    split(p[4], ab[2], as[2]);
    split(p[kLd + 4], ab[3], as[3]);
  };
  // K step s: its three products, committed as one group
  auto run = [&](int s, const uint32_t (&ab)[4], const uint32_t (&as)[4]) {
    const float* big = stages + 2 * (s % kStages) * kStep + 8 * col0;
    const uint64_t db = descriptor(big), ds = descriptor(big + kStep);
    fence();
    wgmma(acc, as, db);
    wgmma(acc, ab, ds);
    wgmma(acc, ab, db);
    commit();
  };
  // one cp.async group a step, empty past the last, so that copy_wait's
  // count stays the steps ahead
  auto copy_step = [&](int u) {
    if (u < steps) fetch<N, kNC>(ring + (u % kRing) * kStep, w, step0 + u, col0);
    copy_commit();
  };
  // after K step s is issued: once this warp's step s - 1 is done, take step
  // s + 1's A fragments into the set step s - 1 used, and stage its operator
  // part (in place since the last barrier) into the stage step s - 2 used
  // (done in every warp before the last barrier); copy step s + kRing into
  // the slot step s was staged from; wait for this thread's copy of step s +
  // 2 before the warpgroup's barrier
  auto advance = [&](int s, uint32_t (&ab)[4], uint32_t (&as)[4]) {
    wait<1>();
    if (s + 1 < steps) {
      load_a((step0 + s + 1) * kKS, ab, as);
      float* b = stages + 2 * ((s + 1) % kStages) * kStep;
      stash<N, kNC>(ring + ((s + 1) % kRing) * kStep, b, b + kStep, col0);
      fence_async();
    }
    copy_step(s + kRing);
    copy_wait<kRing - 2>();
    sync_group();
  };

  for (int u = 0; u < kRing; ++u) copy_step(u);
  copy_wait<kRing - 2>();                             // steps 0 and 1
  sync_group();
  stash<N, kNC>(ring, stages, stages + kStep, col0);
  fence_async();
  // two sets of A fragments: those of step s stay untouched until step s is
  // done, which the wait after step s + 1 makes sure of
  uint32_t ab0[4], as0[4], ab1[4], as1[4];
  load_a(step0 * kKS, ab0, as0);
  sync_group();
  for (int s = 0; s < steps; s += 2) {
    run(s, ab0, as0);
    advance(s, ab1, as1);
    run(s + 1, ab1, as1);
    advance(s + 1, ab0, as0);
  }
  wait<0>();
  copy_wait<0>();
  __syncthreads();
}

// The product's rows into rows 1..kRows of a row buffer (chunk row r -> buffer
// row r + 1), N = 128, the two warpgroups' parts of a kSplitK product added:
// the second's stored, then the first's added to them. Ends with
// __syncthreads().
__device__ __forceinline__ void to_rows(const Acc<128, true>& acc, float* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wq = warp & 3;
  const int r0 = 32 * (wq >> 1) + 4 * (lane >> 2) + 2 * (wq & 1) + 1;
  const int c0 = 2 * (lane & 3);
  if (warp >= 4) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) buf[(r0 + (c >> 1)) * kLd + c0 + 8 * j + (c & 1)] = acc[j][c];
  }
  __syncthreads();
  if (warp < 4) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) buf[(r0 + (c >> 1)) * kLd + c0 + 8 * j + (c & 1)] += acc[j][c];
  }
  __syncthreads();
}

// Store the product's rows to device memory times `gain`, as chain_common.cuh's
// store_rows: row r of the chunk to out + (row0 + r) * 128 for r < rows,
// columns [0,128) to out_lo and [128,256) to out_hi; kParts = 1 stores only
// the first 128 columns.
template <int N, int kParts = N / 128>
__device__ __forceinline__ void store_rows(const Acc<N, false>& acc, float* __restrict__ out_lo,
                                           float* __restrict__ out_hi, size_t base, int row0,
                                           int rows, float gain) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wq = warp & 3;
  const int r0 = 32 * (wq >> 1) + 4 * (lane >> 2) + 2 * (wq & 1);
  const int c0 = (warp >> 2) * (N / 2) + 2 * (lane & 3);     // in n-tile 0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + h;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      const int col = c0 + 8 * j, q = col / kBlk;
      if (q < kParts)
        *reinterpret_cast<float2*>((q ? out_hi : out_lo) + base + (size_t)(row0 + r) * kBlk +
                                   col % kBlk) =
            make_float2(acc[j][2 * h] * gain, acc[j][2 * h + 1] * gain);
    }
  }
}

// ---------------------------------------------------------------------------
// The pre-laid feed (K1-ssb and K1-mono, ssb_fed_kernel in sweep_chain.cuh;
// K2a and K8, mix_demod_kernel in staged.cu).
//
// The operator is split and laid out once, outside the kernel
// (ops/tf32x3.tf32_image): for each K step of the block, both warpgroups'
// parts (their column ranges, or their K steps of a product split over K),
// each big then small in the K-major core-matrix layout above, one
// contiguous block of 16-byte multiples; kUnitSteps consecutive K steps are
// a unit, which the feed moves at once. The block reads its units in a
// fixed order (a Plan: the band-pass's K steps, then PBT's, chunk after
// chunk) through a ring of kSlots slots in shared memory, each slot with a
// "full" and an "empty" mbarrier. A producer warp beside the chain's eight
// (one lane of it) brings each unit in with one 1-D bulk copy
// (cp.async.bulk, complete_tx on the slot's full barrier) straight into the
// slot wgmma reads, as soon as the slot's empty barrier says every reader of
// its previous unit is done: no thread copies or splits the operator, and
// none of the chain's warps spends a cycle on the feed beyond a wait and a
// release a unit. A copy costs its SM about 325 cycles whatever its size up
// to 32 KB, and a barrier operation in the running kernel 100-300 cycles of
// the thread that issues it (diag/tc_engine.py's probe, diag/k1_split.py's
// trace, on an H100), so the bookkeeping sits on the producer's path, and a
// unit is four K steps of both warpgroups' parts (64 KB, two slots): one
// copy, one wait and one release for 24 passes of each warpgroup. Both
// warpgroups wait on full at a unit's first step, take each step's A
// fragments (split as gemm's) and issue its three passes on their part of
// the slot, one group in flight (wgmma.wait_group 1), and release a unit once
// its last step is done: thread 0 of each warpgroup arrives on the slot's
// empty barrier. Each thread's waits go through the units in order, so no
// barrier is ever more than one phase from the parity waited for.
//
// K2a and K8 read a K step of one part that both warpgroups share (kParts =
// 1 below): each warpgroup multiplies 64 rows of a 128-row item by all of
// the step's columns, so that one read of the image from the L2 serves 128
// rows; their unit of four K steps is 32 KB, and their slots are that size.
//
// Every block reads the whole image once a chunk from the L2. Multicast over
// a cluster of two blocks (two channels at the same unit, each copy issued
// once for the pair) halves those reads and, on an H100, ran K1-ssb and
// K1-mono 2-3% slower (diag/k1_split.py's variant multicast): the feed's
// per-SM costs pace it before the L2 does.

namespace feed {

constexpr int kSlots = 2;                    // the block's ring
constexpr int kUnitSteps = 4;                // K steps a unit
constexpr int kSlotFloats = kUnitSteps * 2 * 2 * kKS * 128;   // K1's unit: K steps of two
                                             // parts of 128 columns
constexpr int kRingFloats = kSlots * kSlotFloats;
constexpr int kBars = 2 * kSlots;            // the full barriers, then the empty ones

__device__ __forceinline__ uint32_t addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
// one arrival on this block's barrier, and `bytes` more to come on it
__device__ __forceinline__ void expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
// one arrival on this block's barrier, with the default release at the
// block's scope: the barrier orders the tensor cores' reads of a slot
// before the copy engine's refill, both in the async proxy, as CUTLASS's
// consumer release does (release.cluster makes each arrival a fence of the
// whole memory system, about 1,000 cycles a unit: diag/k1_split.py's
// variant strong)
__device__ __forceinline__ void arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// until the phase of `parity` of this block's barrier has completed
__device__ __forceinline__ void wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` from device memory into this block's slot dst, completing on its
// barrier bar
__device__ __forceinline__ void copy(uint32_t dst, const float* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

}  // namespace feed

// A block's feed: Plan gives unit i's source (src(i), 16-byte aligned) and
// size (bytes(i), a multiple of 16, at most kSlotFloats floats: the size of
// a slot, feed::kSlotFloats by default); the ring at slots, its barriers from
// bars (full[s] at bars + 8 s, empty[s] at bars +
// 8 (kSlots + s)); `total` units in the launch. The producer is lane 0 of
// warp 8, the chain warps 0-7; the block meets at a __syncthreads() between
// setup() and the first wait or copy.
template <class Plan, int kSlotFloats = feed::kSlotFloats>
struct Feed {
  Plan plan;
  float* slots;
  uint32_t bars;
  int total;
  int next;            // the chain's next unit to read

  __device__ __forceinline__ static bool producer() { return threadIdx.x == kThreads; }
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return bars + 8 * (feed::kSlots + s); }
  __device__ __forceinline__ const float* slot(int i) const {
    return slots + (i % feed::kSlots) * kSlotFloats;
  }
  // the producer, before the block's first barrier: the ring's barriers
  __device__ __forceinline__ void setup() const {
    if (!producer()) return;
    for (int s = 0; s < feed::kSlots; ++s) {
      feed::init(full(s), 1);
      feed::init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the producer, after it: every unit, each once its slot is free
  __device__ __forceinline__ void produce() const {
    if (!producer()) return;
    for (int u = 0; u < total; ++u) {
      const int s = u % feed::kSlots;
      if (u >= feed::kSlots) feed::wait(empty(s), (uint32_t)(u / feed::kSlots - 1) & 1u);
      feed::expect(full(s), plan.bytes(u));
      feed::copy(feed::addr(slot(u)), plan.src(u), plan.bytes(u), full(s));
    }
  }
  // every chain thread: until unit i has landed
  __device__ __forceinline__ void wait(int i) const {
    feed::wait(full(i % feed::kSlots), (uint32_t)(i / feed::kSlots) & 1u);
  }
  // thread 0 of each warpgroup, once its products have read unit i
  __device__ __forceinline__ void release(int i) const {
    if ((threadIdx.x & 127) != 0) return;
    feed::arrive(empty(i % feed::kSlots));
  }
};

// A's fragments of K step k, split, for the warpgroup's fragment rows arow
// (+1), columns k + acol (+4): gemm's load_a
__device__ __forceinline__ void a_fragments(const float* lo, const float* hi, int arow, int acol,
                                            int k, uint32_t (&ab)[4], uint32_t (&as)[4]) {
  const float* p = (k >= 256 ? hi : lo) + (arow + ((k >> 7) & 1)) * kLd + (k & 127) + acol;
  split(p[0], ab[0], as[0]);
  split(p[kLd], ab[1], as[1]);
  split(p[4], ab[2], as[2]);
  split(p[kLd + 4], ab[3], as[3]);
}

// acc = A @ the block's next `units` units of its feed, kUnitSteps K steps
// each, of every K step the warpgroup's part (kParts = 2: part wg of the
// step's two; kParts = 1: the step's one part, which both warpgroups read;
// a part is a K step of kNC columns, 64 or 128: m64n64k8 or m64n128k8, big
// then small), summed over
// the steps in order, each as small_a big_b + big_a small_b + big_a big_b; A
// as gemm's, K step s of the warpgroup at A's columns 8 s, or with kSplitK
// 8 (steps wg + s) (acc is then its part of the sum; to_rows adds the two).
// acc's layout is gemm's, its columns the warpgroup's own. Run by the
// chain's 256 threads; ends with ChainSync::sync(), so the caller may
// overwrite what A read.
template <int kNC, bool kSplitK, int kParts = 2, class Plan, int kSlotFloats>
__device__ __forceinline__ void fed_gemm(const float* lo, const float* hi,
                                         Feed<Plan, kSlotFloats>& f, int units,
                                         float (&acc)[kNC / 8][4]) {
  constexpr int kStep = kParts * 2 * kKS * kNC;   // floats of a K step of both warpgroups
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wq = warp & 3, wg = warp >> 2;
  const int arow = 32 * (wq >> 1) + 4 * (lane >> 2) + 2 * (wq & 1);
  const int acol = lane & 3;
  const int steps = units * feed::kUnitSteps;
  const int k0 = kSplitK ? wg * steps * kKS : 0;
  const int i0 = f.next;
#pragma unroll
  for (int j = 0; j < kNC / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  // K step s: its three products on its part of unit i0 + s / kUnitSteps
  // (waited for at the unit's first step), committed as one group
  auto run = [&](int s, const uint32_t (&ab)[4], const uint32_t (&as)[4]) {
    const int i = i0 + s / feed::kUnitSteps;
    if (s % feed::kUnitSteps == 0) f.wait(i);
    const float* big =
        f.slot(i) + (s % feed::kUnitSteps) * kStep + (kParts == 2 ? wg : 0) * 2 * kKS * kNC;
    const uint64_t db = descriptor(big), ds = descriptor(big + kKS * kNC);
    fence();
    wgmma(acc, as, db);
    wgmma(acc, ab, ds);
    wgmma(acc, ab, db);
    commit();
  };
  // after K step s is issued: once step s - 1 is done, release its unit if
  // it was the unit's last, and take step s + 1's A fragments into the set
  // step s - 1 used
  auto advance = [&](int s, uint32_t (&ab)[4], uint32_t (&as)[4]) {
    wait<1>();
    if (s >= 1 && s % feed::kUnitSteps == 0) f.release(i0 + s / feed::kUnitSteps - 1);
    if (s + 1 < steps) a_fragments(lo, hi, arow, acol, k0 + (s + 1) * kKS, ab, as);
  };

  uint32_t ab0[4], as0[4], ab1[4], as1[4];
  a_fragments(lo, hi, arow, acol, k0, ab0, as0);
  for (int s = 0; s < steps; s += 2) {
    run(s, ab0, as0);
    advance(s, ab1, as1);
    run(s + 1, ab1, as1);
    advance(s + 1, ab0, as0);
  }
  wait<0>();
  f.release(i0 + units - 1);
  f.next = i0 + units;
  ChainSync::sync();
}

// to_rows for the chain's 256 threads of a block with a producer warp: ends
// with ChainSync::sync()
__device__ __forceinline__ void fed_to_rows(const Acc<128, true>& acc, float* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wq = warp & 3;
  const int r0 = 32 * (wq >> 1) + 4 * (lane >> 2) + 2 * (wq & 1) + 1;
  const int c0 = 2 * (lane & 3);
  if (warp >= 4) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) buf[(r0 + (c >> 1)) * kLd + c0 + 8 * j + (c & 1)] = acc[j][c];
  }
  ChainSync::sync();
  if (warp < 4) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) buf[(r0 + (c >> 1)) * kLd + c0 + 8 * j + (c & 1)] += acc[j][c];
  }
  ChainSync::sync();
}

}  // namespace tc
}  // namespace
