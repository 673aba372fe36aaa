// staged.cu: the two kernels of the staged SSB chain, with the AGC between
// them left to PyTorch (ops/agc.agc_run), as the JAX package leaves it to XLA.
//
// mix_demod replaces _mix_demod_kernel (radiodsp_sdr_rx_tpu/ops/
// pallas_kernels.py:83, wrapper fused_mix_filter_demod :119): input gain /
// IQ balance (one f32 multiply each, as the JAX caller's xr * in_gain), DDS
// NCO mix, overlap-save band-pass + SSB demod as frames(rows,512) @
// w_ssb(512,128). The frame of row r is [row r-1 | row r] of the
// mixed stream; row -1 is the carried tail (C, 256) [re|im], already scaled
// and not yet mixed, which is mixed at positions -128..-1.
//
// sweep_mix_demod replaces _sweep_kernel (radiodsp_sdr_rx_tpu/ops/
// pallas_sweep.py:59, wrapper sweep_mix_filter_demod :147): the same mix and
// product from a stream start, so row -1 is zeros and nothing is carried in
// or out, no input gains, and the audio stored times out_gain. The TPU kernel
// walks each channel block's whole time axis to keep its framing tail in
// VMEM; here the stream is in device memory, so each item reads the row
// before it straight from the stream and K2a's walk over items serves. It
// is mix_demod_kernel instantiated without the tail load.
//
// pbt replaces _pbt_kernel (pallas_kernels.py:177, wrapper pbt_filter :189):
// frames [row r-1 | row r] of the audio, (rows,256) @ w_pbt(256,256) ->
// [L|R], output gain; row -1 is the carried audio tail (C, 128).
//
// What bounds them on an H100: mix_demod (and sweep_mix_demod) reads 8 B and
// writes 4 B per sample and does 1,024 flops per 128 samples of the product;
// pbt reads 4 B and writes 8 B and does the same 1,024. At 128 channels x
// 2^19 samples each is 68.7 GFLOP against 0.81 GB (0.24 ms at 3.35 TB/s): in
// fp32 outside the tensor cores (67 TFLOP/s) 1.03 ms, bound by arithmetic;
// as three TF32 passes on the tensor cores (495 TFLOP/s dense) 0.42 ms,
// still above the bytes, within a factor of two of them.
//
// What the design does about it: both products run on tc_gemm.cuh's 3xTF32
// tensor-core engine. mix_demod and sweep_mix_demod (mix_demod_kernel) take
// the pre-laid feed: the operator's image (ops/tf32x3.tf32_image(w_ssb, 1),
// built once per operator by ops/staged.mix_image), 64 K steps of 8 KB, each
// one part that both warpgroups read, four K steps (32 KB) a bulk copy of a
// producer warp into a ring of two slots. A block walks 128-row items of the
// (channel, item) pairs, blockIdx.x, + gridDim.x, ..., one block an SM, the
// image streamed from item to item without a drain; per item the 256 chain
// threads mix its 128 rows and the row before them into two row buffers
// (the same mix() and rows as before, so the mixed rows are bit for bit
// chunk_gemm's), then warpgroup 0 multiplies rows 0-63 and warpgroup 1 rows
// 64-127 by all 128 columns over the whole K = 512 (m64n128k8), so that one
// read of the image from the L2 serves 128 rows, and each stores its rows
// from its accumulators. The row before an item is recomputed from the
// stream (1/128 more mixing); before a channel's first item it is the
// carried tail (mix_demod) or zeros (sweep_mix_demod). pbt takes the raw
// feed, two blocks an SM (at most 128 registers), so that one block's loads
// and stores overlap the other's products, its rows copied in with cp.async
// (no stop in registers), on a (channel, 64-row chunk) grid; a block loads
// its chunk's 64 rows and the row before it, from the stream or, for chunk
// 0, from the carried tail; the JAX wrapper's one-block-shifted copy of the
// stream is not made.

#include "chain_common.cuh"
#include "tc_gemm.cuh"

namespace {

constexpr int kPbtRing = 4;   // operator steps copied ahead: what two blocks an SM leave room for
constexpr int kPbtSmemFloats = tc::tile_floats<256, kPbtRing, false>() + kRowBuf;

constexpr int kItemRows = 2 * kRows;                 // rows of an item, 64 a warpgroup
constexpr int kItemBuf = (kItemRows + 1) * kLd;      // a row buffer, row 0 the row before
constexpr int kMixUnits = 512 / tc::kKS / tc::feed::kUnitSteps;   // units of the image
constexpr int kMixSlot = tc::feed::kUnitSteps * 2 * tc::kKS * kBlk;   // a unit: 32 KB
// the ring, the two row buffers, the ring's barriers (8-byte aligned)
constexpr int kMixSmem = 4 * (tc::feed::kSlots * kMixSlot + 2 * kItemBuf) + 8 * tc::feed::kBars;
static_assert(kMixSmem <= 232448, "shared memory of one H100 block");
static_assert((tc::feed::kSlots * kMixSlot + 2 * kItemBuf) % 2 == 0, "the barriers 8-byte aligned");

struct MixArgs {
  const float* xr;
  const float* xi;
  const long long* inc;
  const long long* phase0;
  const float* image;   // the operator's image: kMixUnits units of kMixSlot floats
  const float* tail;    // (C, 256) [re|im], scaled, not mixed (mix_demod alone)
  float* audio;
  int channels, n;
  float g_i, g_q, out_gain;
};

// the source and size of the block's unit i: the image's units, item after item
struct MixPlan {
  const float* image;
  __device__ __forceinline__ const float* src(int i) const {
    return image + (i % kMixUnits) * kMixSlot;
  }
  __device__ __forceinline__ uint32_t bytes(int) const { return 4u * kMixSlot; }
};

// Rows 0..kItemRows of Mr and Mi: stream rows row0-1 .. row0+kItemRows-1 of
// channel c, scaled and mixed, zeros past the stream's `rows` rows from
// row0; stream row -1 is the carried tail (kTail: scaled already, mixed at
// positions -128..-1) or zeros. Row 0 by threads 0-127, loaded first and
// mixed last; rows 1.. by all 256, each four consecutive samples (one float4
// of I and of Q) of 16 rows 8 apart, loaded four rows ahead of their mix: a
// warp's 32 lanes take four rows x eight float4 of one quarter of a row, so
// that their stores at stride kLd fall on 32 banks (row + 4 q + e mod 32).
// The rows' mix has no branch (mix<true>, and rows past the end mixed and
// then replaced by zeros), so that a thread's 16 mixes of a batch interleave.
// The loads pace it (diag/k2a_split.py).
template <bool kTail>
__device__ __forceinline__ void mix_item(const MixArgs& a, int c, int row0, int rows, float* Mr,
                                         float* Mi) {
  constexpr int kAhead = 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)c * a.n;
  const uint32_t ph0 = (uint32_t)a.phase0[c], dph = (uint32_t)a.inc[c];
  const float g_i = kTail ? a.g_i : 1.f, g_q = kTail ? a.g_q : 1.f;
  // row 0's samples, loaded now and mixed after the rows so that their
  // latency overlaps the rows'
  const bool row_before = tid < kBlk && (row0 > 0 || kTail);
  float x0 = 0.f, y0 = 0.f;
  if (row_before) {
    const float* t = a.tail + (size_t)c * 2 * kBlk + tid;
    x0 = row0 > 0 ? a.xr[base + (row0 - 1) * kBlk + tid] : t[0];
    y0 = row0 > 0 ? a.xi[base + (row0 - 1) * kBlk + tid] : t[kBlk];
  }
  const int col = 4 * (8 * (warp & 3) + (lane & 7));
  const int r1 = 4 * (warp >> 2) + (lane >> 3);     // the thread's rows: r1, r1 + 8, ...
  for (int v0 = 0; v0 < kItemRows / 8; v0 += kAhead) {
    float4 x[kAhead], y[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int r = r1 + 8 * (v0 + u);
      x[u] = y[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows) {
        const size_t o = base + (size_t)(row0 + r) * kBlk + col;
        x[u] = __ldg(reinterpret_cast<const float4*>(a.xr + o));
        y[u] = __ldg(reinterpret_cast<const float4*>(a.xi + o));
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int r = r1 + 8 * (v0 + u);
      const float xs[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
      const float ys[4] = {y[u].x, y[u].y, y[u].z, y[u].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = (row0 + r) * kBlk + col + e;
        float vr, vi;
        mix<true>(xs[e], ys[e], ph0 + (uint32_t)pos * dph, g_i, g_q, vr, vi);
        Mr[(r + 1) * kLd + col + e] = r < rows ? vr : 0.f;
        Mi[(r + 1) * kLd + col + e] = r < rows ? vi : 0.f;
      }
    }
  }
  if (tid < kBlk) {
    const int pos = (row0 - 1) * kBlk + tid;
    float vr = 0.f, vi = 0.f;
    if (row_before)   // the stream's, or the carried tail's (scaled already)
      mix<true>(x0, y0, ph0 + (uint32_t)pos * dph, row0 > 0 ? g_i : 1.f, row0 > 0 ? g_q : 1.f,
                vr, vi);
    Mr[tid] = vr;
    Mi[tid] = vi;
  }
}

// A warpgroup's product rows to device memory times `gain`: its fragment
// row r (tc_gemm.cuh's layout, all 128 columns) is row row0 + r of the
// channel at base, stored while r < rows; each thread's two columns a float2.
__device__ __forceinline__ void store_item(const float (&acc)[16][4], float* __restrict__ out,
                                           size_t base, int row0, int rows, float gain) {
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int r0 = 32 * (wq >> 1) + 4 * (lane >> 2) + 2 * (wq & 1);
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + h;
    if (r >= rows) continue;
    float* o = out + base + (size_t)(row0 + r) * kBlk + c0;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(o + 8 * j) = make_float2(acc[j][2 * h] * gain,
                                                          acc[j][2 * h + 1] * gain);
  }
}

// kTail: mix_demod, row -1 of a channel's first item the carried tail, input
// gains, the audio stored as it is. Else sweep_mix_demod: row -1 zeros (the
// tail load compiled out), no input gains, the audio stored times out_gain.
// 288 threads: the chain's warps 0-7 meet at ChainSync's named barrier, lane
// 0 of warp 8 brings in the image, unit after unit, for all the block's
// items (tc::Feed).
template <bool kTail>
__global__ void __launch_bounds__(kThreads + 32, 1) mix_demod_kernel(const MixArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* Mr = smem + tc::feed::kSlots * kMixSlot;   // mixed I rows, row 0 the row before
  float* Mi = Mr + kItemBuf;                        // mixed Q rows
  const uint32_t bars = tc::feed::addr(Mi + kItemBuf);

  const int nrows = a.n / kBlk, per = (nrows + kItemRows - 1) / kItemRows;
  const int items = a.channels * per;
  const int mine = (int)blockIdx.x < items ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  tc::Feed<MixPlan, kMixSlot> feed{MixPlan{a.image}, smem, bars, mine * kMixUnits, 0};
  feed.setup();
  __syncthreads();            // the ring's barriers set up before any copy or wait
  if (threadIdx.x >= kThreads) {
    feed.produce();
    return;
  }
  const int half = kRows * (threadIdx.x >> 7);      // the warpgroup's first row of an item
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int c = item / per, row0 = (item % per) * kItemRows;
    const int rows = min(kItemRows, nrows - row0);
    mix_item<kTail>(a, c, row0, rows, Mr, Mi);
    ChainSync::sync();
    tc::Acc<128, true> acc;
    tc::fed_gemm<128, false, 1>(Mr + half * kLd, Mi + half * kLd, feed, kMixUnits, acc);
    store_item(acc, a.audio, (size_t)c * a.n, row0 + half, rows - half,
               kTail ? 1.f : a.out_gain);
  }
}

// Two blocks an SM: at most 128 registers, and 2 x 115,460 B of shared
// memory.
__global__ void __launch_bounds__(kThreads, 2) pbt_kernel(
    const float* __restrict__ audio, const float* __restrict__ w_pbt,
    const float* __restrict__ tail, float* __restrict__ out_l,
    float* __restrict__ out_r, int n, float out_gain) {
  extern __shared__ __align__(16) float smem[];
  float* tiles = smem;                            // the operator tiles
  float* Ab = tiles + tc::tile_floats<256, kPbtRing, false>();   // audio rows, row 0 = the row before the chunk

  const int c = blockIdx.x, tid = threadIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, n / kBlk - row0);
  const size_t base = (size_t)c * n;

  // rows 0..kRows: stream rows row0-1 .. row0+kRows-1 (the tail before the
  // stream, zeros past its end), copied without a stop in registers
  for (int e = tid; e < (kRows + 1) * kBlk; e += kThreads) {
    const int r = e / kBlk, j = e % kBlk;
    const int pos = (row0 + r - 1) * kBlk + j;
    const float* src = pos < 0 ? tail + (size_t)c * kBlk + j : audio + base + pos;
    tc::copy4(Ab + r * kLd + j, r <= rows ? src : audio, r <= rows ? 4 : 0);
  }
  tc::copy_commit();
  tc::copy_wait<0>();
  __syncthreads();

  tc::Acc<256, false> acc;
  tc::gemm<256, kPbtRing, false>(Ab, Ab, w_pbt, 256, tiles, acc);
  tc::store_rows<256>(acc, out_l, out_r, base, row0, rows, out_gain);
}

int prepare(const void* kernel, int smem, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return (int)err;
}

dim3 grid(int channels, int n) {
  return dim3(channels, (n / kBlk + kRows - 1) / kRows);
}

// mix_demod_kernel<kTail> on one block an SM, or one an item where there
// are fewer items
template <bool kTail>
int launch_mix(const MixArgs& a, int device, void* stream) {
  int sms = 0;
  int err = prepare(reinterpret_cast<const void*>(&mix_demod_kernel<kTail>), kMixSmem, device);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err) return err;
  const int items = a.channels * ((a.n / kBlk + kItemRows - 1) / kItemRows);
  mix_demod_kernel<kTail><<<min(items, sms), kThreads + 32, kMixSmem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream` of CUDA device `device`; each returns the cudaError_t
// of the launch (0 on success). Pointers are device pointers to contiguous
// tensors: xr, xi, audio, out_l, out_r (C, n); inc, phase0 (C,) int64 DDS
// words; tail (C, 256) [re|im] for mix_demod, (C, 128) for pbt; image the
// (512, 128) operator's image (64, 1, 2, 1024), 16-byte aligned.
extern "C" int mix_demod(const float* xr, const float* xi, const long long* inc,
                         const long long* phase0, const float* image,
                         const float* tail, float* audio, int channels, int n,
                         int device, float g_i, float g_q, void* stream) {
  return launch_mix<true>(MixArgs{xr, xi, inc, phase0, image, tail, audio, channels, n, g_i, g_q,
                                  1.f}, device, stream);
}

extern "C" int sweep_mix_demod(const float* xr, const float* xi, const long long* inc,
                               const long long* phase0, const float* image, float* audio,
                               int channels, int n, int device, float out_gain,
                               void* stream) {
  return launch_mix<false>(MixArgs{xr, xi, inc, phase0, image, nullptr, audio, channels, n, 1.f,
                                   1.f, out_gain}, device, stream);
}

extern "C" int pbt(const float* audio, const float* w_pbt, const float* tail,
                   float* out_l, float* out_r, int channels, int n, int device,
                   float out_gain, void* stream) {
  const int smem = kPbtSmemFloats * (int)sizeof(float);
  const int err = prepare((const void*)pbt_kernel, smem, device);
  if (err) return err;
  pbt_kernel<<<grid(channels, n), kThreads, smem, (cudaStream_t)stream>>>(
      audio, w_pbt, tail, out_l, out_r, n, out_gain);
  return (int)cudaGetLastError();
}
