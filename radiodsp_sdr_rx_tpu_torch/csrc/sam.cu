// sam.cu: the SAM carrier PLL over a segment: K5 of the staged FusedSAMBank,
// and sam_exact, the exact PLL of demod_sam_planar (the reference chain, the
// Receiver, the sharded chains).
//
// Replaces _sam_kernel (radiodsp_sdr_rx_tpu/ops/pallas_sam.py:226; wrapper
// sam_pll_run_pallas :258). Per channel and sample, sam_pll.cuh's step: the
// in-phase product vr = Re(z * conj(ref)) goes out, the phase detector
// atan2(Im, Re) drives a second-order loop (freq += ki*err clipped to
// +-max_freq, phase += freq + kp*err wrapped into [0, 2*pi)); the oscillator
// re-seeds from the phase every `period` samples (the JAX chunk, 4096 or the
// whole segment when shorter). The (C,) phase and frequency carry out.
//
// What bounds it on an H100: not bytes (12 B per sample per channel) nor
// operations (about 72 flops per sample), but the chain of dependent
// instructions from one sample's phase error to the next one's (the
// rotation of the next product, the atan2 with its divide, the loop update)
// and, a step behind it, the base oscillator's path from the new phase. A
// segment of n samples costs n such steps whatever the channel count, and
// with about a hundred instructions a step, the one warp that walks them
// also comes close to its scheduler's issue rate.
//
// What the design does about it: sam_pll.cuh's step, arranged to shorten
// the chain (the folded rotation, the early clip bounds, the atan2's octant
// folded into its polynomial, the divide without its slow-path branch, the
// re-seeds outside the unrolled loop). One thread per channel walks its time
// axis, so 32 channels share one warp's chain. A block owns 32 channels and
// has five warps: warp 0 runs the PLLs out of shared memory while warps 1-4
// load the next tile of 128 samples of the 32 channels (thread q the column
// q of every row: coalesced, 16 loads in flight a thread) and store the
// previous tile's vr, so that no global memory latency sits on the chain.
// (With one copy warp the loads went one DRAM latency at a time and the
// copy, not the chain, set the pace: 182.5 ms per config6 segment on an
// H100.) Rows are padded to 129 floats, so the 32 threads reading one column
// hit 32 banks. Channels past the end compute on zeros and store nothing.
//
// sam_exact is the same launch walking another step: demod_sam_planar's
// exact recurrence (radiodsp_sdr_rx_tpu/ops/planar.py:154-186, a jax.lax.scan
// there and no Pallas kernel), cos and sin of the carried phase, vr = zr*cr +
// zi*ci, err = atan2(zi*cr - zr*ci, vr), freq = clamp(freq + ki*err,
// +-max_freq), phase = remainder(phase + freq + kp*err, 2*pi); no folded
// step and no re-seed. Its operations are those of the plain loop
// (ops/planar.demod_sam_planar_plain) as PyTorch runs them on the card, one
// elementwise kernel an operation: the IEEE libm cosf, sinf and atan2f (this
// build has no --use_fast_math), each product and sum rounded on its own
// (__fmul_rn, __fadd_rn: no contraction into an FMA), the clamp with the NaN
// passed through, the remainder as fmodf and then + 2*pi where its sign
// differs from the divisor's. So it gives the loop's bits. Its chain a step
// is the whole libm path, from the phase through sincos, the atan2 with its
// divide, the loop update and fmodf, several times K5's; one lane walks one
// channel, so a segment costs n such steps whatever the channel count.
//
// sam_probe applies the device divide and atan2 to arrays, for the tests.

#include <cuda_runtime.h>

#include "sam_pll.cuh"

namespace {

constexpr int kCh = 32;          // channels per block, one per lane of warp 0
constexpr int kTile = 128;       // samples per tile, one per copy thread
constexpr int kLdT = kTile + 1;  // padded row stride
constexpr int kTileFloats = kCh * kLdT;
constexpr int kBlockThreads = 32 + kTile;   // the PLL warp, then the copy warps

// demod_sam_planar's step on the carried phase and freq (the other fields
// of Pll unused): returns vr, the in-phase product before the DC blocker
__device__ __forceinline__ float exact_step(Pll& pll, float zr, float zi, const PllGains& g) {
  const float cr = cosf(pll.phase), ci = sinf(pll.phase);
  const float vr = __fadd_rn(__fmul_rn(zr, cr), __fmul_rn(zi, ci));
  const float vi = __fsub_rn(__fmul_rn(zi, cr), __fmul_rn(zr, ci));
  const float err = atan2f(vi, vr);
  float f = __fadd_rn(pll.freq, __fmul_rn(g.ki, err));
  if (!isnan(f)) f = fminf(fmaxf(f, -g.max_freq), g.max_freq);   // torch.clamp
  float m = fmodf(__fadd_rn(__fadd_rn(pll.phase, f), __fmul_rn(g.kp, err)), kTwoPi);
  if (m < 0.f) m = __fadd_rn(m, kTwoPi);   // torch.remainder: the divisor is > 0
  pll.phase = m;
  pll.freq = f;
  return vr;
}

// the exact step over `len` samples of a row, each loaded a step ahead;
// zr[len] and zi[len] must be readable (the row's padding)
__device__ __forceinline__ void exact_row(Pll& pll, const PllGains& g, int len, const float* zr,
                                          const float* zi, float* vr) {
  float r = zr[0], i = zi[0];
  for (int k = 0; k < len; ++k) {
    const float r_next = zr[k + 1], i_next = zi[k + 1];
    vr[k] = exact_step(pll, r, i, g);
    r = r_next;
    i = i_next;
  }
}

// kExact = false: K5 (sam_pll.cuh's step, re-seeded every `period`);
// true: sam_exact (exact_step; `period` unused)
template <bool kExact>
__global__ void __launch_bounds__(kBlockThreads) sam_pll_kernel(
    const float* __restrict__ zr, const float* __restrict__ zi,
    const float* __restrict__ phase0, const float* __restrict__ freq0,
    float* __restrict__ vr_out, float* __restrict__ phase_out,
    float* __restrict__ freq_out, int channels, int n, int period, float kp,
    float ki, float max_freq) {
  extern __shared__ float smem[];
  float* zin = smem;                       // [2 slots][zr | zi][kCh][kLdT]
  float* vbuf = smem + 4 * kTileFloats;    // [2 slots][kCh][kLdT]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = threadIdx.x - 32;   // a copy thread's column
  const int c0 = blockIdx.x * kCh;
  const int tiles = (n + kTile - 1) / kTile;

  // copy threads: column q of tile t of the block's channels into slot t & 1
  // (zeros past the end)
  auto load = [&](int t) {
    float* dr = zin + (t & 1) * 2 * kTileFloats + q;
    float* di = dr + kTileFloats;
    const int pos = t * kTile + q;
#pragma unroll 8
    for (int ch = 0; ch < kCh; ++ch) {
      const bool ok = c0 + ch < channels && pos < n;
      const size_t o = (size_t)(c0 + ch) * n + pos;
      dr[ch * kLdT] = ok ? zr[o] : 0.f;
      di[ch * kLdT] = ok ? zi[o] : 0.f;
    }
  };
  auto store = [&](int t) {
    const float* src = vbuf + (t & 1) * kTileFloats + q;
    const int pos = t * kTile + q;
    if (pos < n)
      for (int ch = 0; ch < kCh && c0 + ch < channels; ++ch)
        vr_out[(size_t)(c0 + ch) * n + pos] = src[ch * kLdT];
  };

  const int c = c0 + lane;
  const PllGains gains{kp, ki, max_freq};
  const Reseed reseed{period, n, period};
  Pll pll{};
  if (warp == 0 && c < channels) {
    pll.phase = phase0[c];
    pll.freq = freq0[c];
  }
  int next = 0;   // the next re-seed position

  if (warp > 0) load(0);
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    if (warp == 0) {
      const float* a = zin + (t & 1) * 2 * kTileFloats + lane * kLdT;
      const float* b = a + kTileFloats;
      float* v = vbuf + (t & 1) * kTileFloats + lane * kLdT;
      if constexpr (kExact)
        exact_row(pll, gains, min(kTile, n - t * kTile), a, b, v);
      else
        walk_row(pll, gains, reseed, next, t * kTile, min(kTile, n - t * kTile), a, b, v);
    } else {
      if (t + 1 < tiles) load(t + 1);
      if (t > 0) store(t - 1);
    }
    __syncthreads();
  }
  if (warp > 0) store(tiles - 1);
  if (warp == 0 && c < channels) {
    phase_out[c] = pll.phase;
    freq_out[c] = pll.freq;
  }
}

}  // namespace

namespace {

template <bool kExact>
int launch_pll(const float* zr, const float* zi, const float* phase0, const float* freq0,
               float* vr_out, float* phase_out, float* freq_out, int channels, int n,
               int period, float kp, float ki, float max_freq, int device, void* stream) {
  const int smem = 6 * kTileFloats * (int)sizeof(float);
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sam_pll_kernel<kExact>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  sam_pll_kernel<kExact><<<(channels + kCh - 1) / kCh, kBlockThreads, smem,
                           (cudaStream_t)stream>>>(zr, zi, phase0, freq0, vr_out, phase_out,
                                                   freq_out, channels, n, period, kp, ki,
                                                   max_freq);
  return (int)cudaGetLastError();
}

}  // namespace

// K5 on `stream` of CUDA device `device`: zr, zi, vr_out (C, n); phase0,
// freq0, phase_out, freq_out (C,); the oscillator re-seeds every `period`
// samples. Returns the cudaError_t of the launch (0 on success).
extern "C" int sam_pll(const float* zr, const float* zi, const float* phase0,
                       const float* freq0, float* vr_out, float* phase_out,
                       float* freq_out, int channels, int n, int period, float kp,
                       float ki, float max_freq, int device, void* stream) {
  return launch_pll<false>(zr, zi, phase0, freq0, vr_out, phase_out, freq_out, channels, n,
                           period, kp, ki, max_freq, device, stream);
}

// sam_exact on `stream` of CUDA device `device`, the same arguments but the
// period: any n >= 1. Returns the cudaError_t of the launch.
extern "C" int sam_exact(const float* zr, const float* zi, const float* phase0,
                         const float* freq0, float* vr_out, float* phase_out,
                         float* freq_out, int channels, int n, float kp, float ki,
                         float max_freq, int device, void* stream) {
  return launch_pll<true>(zr, zi, phase0, freq0, vr_out, phase_out, freq_out, channels, n, n,
                          kp, ki, max_freq, device, stream);
}

namespace {

__global__ void sam_probe_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                 float* __restrict__ q, float* __restrict__ q_ref,
                                 float* __restrict__ t, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    q[i] = div_rn(a[i], b[i]);
    q_ref[i] = a[i] / b[i];
    t[i] = atan2_poly(a[i], b[i]);
  }
}

}  // namespace

// The probe on `stream` of CUDA device `device`, over n elements: q =
// div_rn(a, b), q_ref = a / b (the compiler's IEEE divide), t =
// atan2_poly(a, b) (y = a, x = b). Returns the cudaError_t of the launch.
extern "C" int sam_probe(const float* a, const float* b, float* q, float* q_ref, float* t,
                         int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  sam_probe_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(a, b, q, q_ref, t, n);
  return (int)cudaGetLastError();
}
