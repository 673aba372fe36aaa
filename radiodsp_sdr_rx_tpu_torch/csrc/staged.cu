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
// VMEM; here the stream is in device memory, so each chunk reads the row
// before it straight from the stream and K2a's (channel, chunk) grid serves.
// It is mix_demod_kernel instantiated without the tail load.
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
// What the design does about it: mix_demod's product is chain_common.cuh's
// register-blocked fp32 FMA, as in sweep_chain.cu; pbt's runs on
// tc_gemm.cuh's 3xTF32 tensor-core engine, two blocks an SM (at most 128
// registers), so that one block's loads and stores overlap the other's
// products, its rows copied in with cp.async (no stop in registers). Both
// kernels are stateless, so the grid is (channel, 64-row chunk): 64 blocks
// per channel at the full width instead of the sweep's one, and no carry
// between blocks. A block loads its chunk's 64 rows and the row before it,
// from the stream or, for chunk 0, from the carried tail; the JAX wrapper's
// one-block-shifted copy of the stream is not made.

#include "chain_common.cuh"
#include "tc_gemm.cuh"

namespace {

constexpr int kMixSmemFloats = kAsFloats + kBsFloats + 2 * kRowBuf;
constexpr int kPbtRing = 4;   // operator steps copied ahead: what two blocks an SM leave room for
constexpr int kPbtSmemFloats = tc::tile_floats<256, kPbtRing, false>() + kRowBuf;

// kTail: mix_demod, row -1 of chunk 0 the carried tail, input gains, the
// audio stored as it is. Else sweep_mix_demod: row -1 zeros (the tail load
// compiled out), no input gains, the audio stored times out_gain.
template <bool kTail>
__global__ void __launch_bounds__(kThreads) mix_demod_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const long long* __restrict__ inc, const long long* __restrict__ phase0,
    const float* __restrict__ w_ssb, const float* __restrict__ tail,
    float* __restrict__ audio, int n, float g_i, float g_q, float out_gain) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = As + kAsFloats;
  float* Mr = Bs + kBsFloats;  // mixed I rows, row 0 = the row before the chunk
  float* Mi = Mr + kRowBuf;

  const int c = blockIdx.x, tid = threadIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, n / kBlk - row0);
  const size_t base = (size_t)c * n;
  const uint32_t ph0 = (uint32_t)phase0[c];
  const uint32_t dph = (uint32_t)inc[c];

  // rows 0..kRows hold stream rows row0-1 .. row0+kRows-1 (zeros past the end)
  for (int e = tid; e < (kRows + 1) * kBlk; e += kThreads) {
    const int r = e / kBlk, j = e % kBlk;
    const int pos = (row0 + r - 1) * kBlk + j;
    float vr = 0.f, vi = 0.f;
    if (pos < 0) {  // the carried tail, scaled already; zeros at a stream start
      if constexpr (kTail)
        mix(tail[(size_t)c * 2 * kBlk + j], tail[(size_t)c * 2 * kBlk + kBlk + j],
            ph0 + (uint32_t)pos * dph, 1.f, 1.f, vr, vi);
    } else if (r <= rows) {
      mix(xr[base + pos], xi[base + pos], ph0 + (uint32_t)pos * dph, kTail ? g_i : 1.f,
          kTail ? g_q : 1.f, vr, vi);
    }
    Mr[r * kLd + j] = vr;
    Mi[r * kLd + j] = vi;
  }
  __syncthreads();

  float acc[8][4];
  chunk_gemm<128>(Mr, Mi, w_ssb, 512, As, Bs, acc);
  store_rows<128>(acc, audio, nullptr, base, row0, rows, kTail ? 1.f : out_gain);
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

}  // namespace

// Launch on `stream` of CUDA device `device`; each returns the cudaError_t
// of the launch (0 on success). Pointers are device pointers to contiguous
// tensors: xr, xi, audio, out_l, out_r (C, n); inc, phase0 (C,) int64 DDS
// words; tail (C, 256) [re|im] for mix_demod, (C, 128) for pbt.
extern "C" int mix_demod(const float* xr, const float* xi, const long long* inc,
                         const long long* phase0, const float* w_ssb,
                         const float* tail, float* audio, int channels, int n,
                         int device, float g_i, float g_q, void* stream) {
  const int smem = kMixSmemFloats * (int)sizeof(float);
  const int err = prepare(reinterpret_cast<const void*>(&mix_demod_kernel<true>), smem, device);
  if (err) return err;
  mix_demod_kernel<true><<<grid(channels, n), kThreads, smem, (cudaStream_t)stream>>>(
      xr, xi, inc, phase0, w_ssb, tail, audio, n, g_i, g_q, 1.f);
  return (int)cudaGetLastError();
}

extern "C" int sweep_mix_demod(const float* xr, const float* xi, const long long* inc,
                               const long long* phase0, const float* w_ssb, float* audio,
                               int channels, int n, int device, float out_gain,
                               void* stream) {
  const int smem = kMixSmemFloats * (int)sizeof(float);
  const int err = prepare(reinterpret_cast<const void*>(&mix_demod_kernel<false>), smem, device);
  if (err) return err;
  mix_demod_kernel<false><<<grid(channels, n), kThreads, smem, (cudaStream_t)stream>>>(
      xr, xi, inc, phase0, w_ssb, nullptr, audio, n, 1.f, 1.f, out_gain);
  return (int)cudaGetLastError();
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
