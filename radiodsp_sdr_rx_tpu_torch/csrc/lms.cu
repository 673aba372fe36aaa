// lms.cu: the normalised-LMS noise reducer / auto-notch of a channel bank,
// one warp per channel.
//
// Replaces the TPU kernels _lms_kernel (radiodsp_sdr_rx_tpu/ops/pallas_lms.py:36)
// and _lms_grouped_kernel (:320), both reached through lms_nr_run_pallas
// (:380); the two compute one function, CMSIS arm_lms_norm_f32 with the
// reference's 128-sample decorrelation delay (ops/lms.py). Per sample n of a
// channel, with win the last 96 inputs (win[95] = x[n]) and the desired
// signal d[n] = x[n-128] (from the carried delay line for n < 128, or x[n]
// itself there while `first`, the reference's first-block quirk):
//   y = w . win,  e = d[n] - y,  w += (mu * e / (||win||^2 + eps)) * win,
// and the output is y (denoise) or e (notch). ||win||^2 is summed afresh
// every step, as ops/lms.lms_nr_run does; the TPU kernel's running energy
// is a VPU economy, not the semantics.
//
// What bounds it on an H100: per sample 576 flops (the 96-tap dot, the
// energy and the update, 2*96 each) and 8 B of device memory (x read, the
// output written): 128 channels x 2^19 samples are 39 GFLOP (0.58 ms at the
// 67 TFLOP/s fp32 rate) and 0.54 GB (0.16 ms at 3.35 TB/s). Neither is the
// real limit: every step needs the weights of the step before, so each
// channel is a chain of 2^19 dependent steps, and the time is the latency
// of one step (three FMAs, a five-level warp butterfly, the error and the
// update) times 2^19.
//
// What the design does about it: one warp per channel and one block per
// warp, so each channel's chain runs on an SM sub-partition of its own. The
// step itself (the weights in registers, the 128-float input ring, the float2
// butterfly) is lms_step.cuh's, which the folded chains (sweep_chain.cuh)
// run too. Desired samples and outputs move 32 at a time, coalesced, the
// former broadcast with __shfl_sync. The segment is walked in one launch; the
// delay line's next state (the segment's last 128 inputs) is the wrapper's
// slice.

#include "lms_step.cuh"

namespace {

using lms::kDelay;
using lms::kRing;
using lms::kTaps;

__global__ void __launch_bounds__(32) lms_kernel(
    const float* __restrict__ x, const float* __restrict__ w_in,
    const float* __restrict__ win_in, const float* __restrict__ delay,
    const unsigned char* __restrict__ first, float* __restrict__ out,
    float* __restrict__ w_out, float* __restrict__ win_out, int n, float mu,
    int notch) {
  __shared__ float ring[kRing];   // x[m] at slot m & (kRing - 1), m >= -96
  const int c = blockIdx.x, lane = threadIdx.x;
  const float* xc = x + (size_t)c * n;
  float* oc = out + (size_t)c * n;
  const bool fst = *first != 0;

  lms::Warp lw;
  lw.load(w_in + c * kTaps, win_in + c * kTaps, ring);
  for (int t0 = 0; t0 < n; t0 += 32) {
    const int m = t0 + lane;
    float dv = 0.f;
    __syncwarp();   // the previous tile's window loads are done
    if (m < n) {
      const float xv = xc[m];
      dv = m >= kDelay ? xc[m - kDelay] : (fst ? xv : delay[c * kDelay + m]);
      ring[m & (kRing - 1)] = xv;   // replaces x[m - 128], older than every window here
    }
    __syncwarp();
    const float o = lw.tile(ring, t0, min(32, n - t0), dv, mu, notch);
    if (m < n) oc[m] = o;
  }
  __syncwarp();
  lw.store(w_out + c * kTaps, win_out + c * kTaps, ring, n);
}

}  // namespace

// Launch on `stream` of CUDA device `device`; returns the cudaError_t of the
// launch (0 on success). x and out (C, n), w_in/win_in/w_out/win_out (C, 96),
// delay (C, 128): device pointers to contiguous f32 tensors; first: one byte,
// nonzero for the stream's first segment. notch != 0 writes e, else y.
extern "C" int lms_nr(const float* x, const float* w_in, const float* win_in,
                      const float* delay, const unsigned char* first,
                      float* out, float* w_out, float* win_out, int channels,
                      int n, int device, float mu, int notch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  lms_kernel<<<channels, 32, 0, (cudaStream_t)stream>>>(
      x, w_in, win_in, delay, first, out, w_out, win_out, n, mu, notch);
  return (int)cudaGetLastError();
}
