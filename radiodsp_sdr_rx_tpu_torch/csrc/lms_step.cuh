// lms_step.cuh: one warp's normalised-LMS recurrence, shared by the two
// kernels that run it (lms.cu: K3; sweep_chain.cuh: the chains with the LMS
// denoiser or auto-notch folded in).
//
// CMSIS arm_lms_norm_f32 with the reference's 128-sample decorrelation delay
// (ops/lms.py). Per sample t, with win the last 96 inputs (win[95] = x[t])
// and the desired sample d[t] = x[t-128]:
//   y = w . win,  e = d[t] - y,  w += (mu * e / (||win||^2 + eps)) * win.
// Lane l of the warp holds the weights l, l+32 and l+64 in registers. The
// inputs sit in a ring of 128 floats in shared memory (x[m] at slot
// m mod 128), which the caller fills 32 at a time: at the start of each
// 32-sample tile every lane stores one input, which overwrites only samples
// older than any window of the tile, so the steps themselves need no barrier
// and their window loads depend on nothing the chain computes. Dot product
// and energy reduce together in one float2 butterfly (__shfl_xor_sync),
// after which every lane holds the same y and energy. Only the dot, the
// butterfly, e, the scale and the update are on the chain of dependent
// steps: the energy and its reciprocal depend on the input alone.
//
// The calling warp is threads 0..31 of its block (lane == threadIdx.x).

#pragma once

#include <cuda_runtime.h>

namespace {
namespace lms {

constexpr int kTaps = 96;               // ops/lms.LMS_TAPS
constexpr int kDelay = 128;             // ops/lms.LMS_DELAY
constexpr int kPer = kTaps / 32;        // weights per lane
constexpr int kRing = 128;              // input ring, a power of two >= kTaps + 32
constexpr float kEps = 1.1920929e-7f;   // CMSIS DELTA of arm_lms_norm_f32
constexpr unsigned kFull = 0xffffffffu;

static_assert(kRing >= kTaps + 32 && (kRing & (kRing - 1)) == 0, "the ring holds a tile's windows");

struct Warp {
  float w[kPer];

  // the weights, and the window win[j] = x[j - 96] into the ring
  __device__ __forceinline__ void load(const float* __restrict__ w_in,
                                       const float* __restrict__ win_in, float* ring) {
    const int lane = threadIdx.x;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = lane + 32 * k;
      w[k] = w_in[j];
      ring[(j - kTaps) & (kRing - 1)] = win_in[j];
    }
  }

  // steps t0 .. t0 + steps - 1 over the ring, lane s holding the desired
  // sample of step t0 + s in dv; returns the output of step t0 + lane, e
  // when `notch`, else y
  __device__ __forceinline__ float tile(const float* ring, int t0, int steps, float dv,
                                        float mu, int notch) {
    const int lane = threadIdx.x;
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < steps; ++s) {
      const int t = t0 + s;
      // win[j] = x[t - 95 + j]
      float v[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) v[k] = ring[(t - kTaps + 1 + lane + 32 * k) & (kRing - 1)];
      const float dn = __shfl_sync(kFull, dv, s);
      float y = w[0] * v[0], q = v[0] * v[0];
#pragma unroll
      for (int k = 1; k < kPer; ++k) {
        y = fmaf(w[k], v[k], y);
        q = fmaf(v[k], v[k], q);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        y += __shfl_xor_sync(kFull, y, off);
        q += __shfl_xor_sync(kFull, q, off);
      }
      const float e = dn - y;
      const float g = (mu * e) * __frcp_rn(q + kEps);
#pragma unroll
      for (int k = 0; k < kPer; ++k) w[k] = fmaf(g, v[k], w[k]);
      if (lane == s) o = notch ? e : y;
    }
    return o;
  }

  // the weights, and the window: the last 96 of the n samples walked
  __device__ __forceinline__ void store(float* __restrict__ w_out, float* __restrict__ win_out,
                                        const float* ring, int n) const {
    const int lane = threadIdx.x;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = lane + 32 * k;
      w_out[j] = w[k];
      win_out[j] = ring[(n - kTaps + j) & (kRing - 1)];
    }
  }
};

}  // namespace lms
}  // namespace
