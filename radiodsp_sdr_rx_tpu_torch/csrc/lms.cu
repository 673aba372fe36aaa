// lms.cu: the normalised-LMS noise reducer / auto-notch of a channel bank,
// three warps per channel.
//
// Replaces the TPU kernels _lms_kernel (radiodsp_sdr_rx_tpu/ops/pallas_lms.py:36)
// and _lms_grouped_kernel (:320), both reached through lms_nr_run_pallas
// (:380); the two compute one function, CMSIS arm_lms_norm_f32 with the
// reference's 128-sample decorrelation delay (ops/lms.py). Per sample n of a
// channel, with win the last 96 inputs (win[95] = x[n]) and the desired
// signal d[n] = x[n-128] (from the carried delay line for n < 128, or x[n]
// itself there while `first`, the reference's first-block quirk):
//   y = w . win,  e = d[n] - y,  w += (mu * e / (||win||^2 + eps)) * win,
// and the output is y (denoise) or e (notch). The energies ||win||^2 and
// the lag products of the grouped algebra slide one sample at a time and
// are summed afresh every 128 samples (lms_step.cuh), as the TPU kernel's
// _grouped_macro_r (:230) does; ops/lms_bank.py's plain version keeps the
// same schedule.
//
// What bounds it on an H100: per sample 576 flops (the 96-tap dot, the
// energy and the update, 2*96 each) and 8 B of device memory (x read, the
// output written): 128 channels x 2^19 samples are 39 GFLOP (0.58 ms at the
// 67 TFLOP/s fp32 rate) and 0.54 GB (0.16 ms at 3.35 TB/s). Neither is the
// real limit: each channel is a chain of 2^19 steps, each needing the
// weights of the step before, so the time is the latency of what stays
// serial per sample, times 2^19.
//
// What the design does about it: the grouped exact algebra of lms_step.cuh
// (the TPU kernel's _grouped_macro), 16 samples a group, walked by the
// block's three warps a tile of 32 samples apart: warp 1 takes the inputs
// and forms the lag products and scales, warp 2 inverts each group's
// triangular system, warp 0 holds the weights and forms the predictions,
// c = A b, the outputs and the update, so that of the per-sample chain only
// two warp-wide broadcasts a group are left on the weights' path. One block
// per channel: 128 channels fill 128 of the 132 SMs. The inputs come from
// device memory two tiles ahead through cp.async (into shared memory, so
// that the walk's barrier does not wait for them), the outputs go out eight
// tiles at a time; both coalesced. The segment is walked in one launch;
// the delay line's next state (the segment's last 128 inputs) is the
// wrapper's slice.

#include "lms_step.cuh"

namespace {

using lms::kDelay;
using lms::kTaps;
using lms::kTile;

constexpr int kStageIn = 4;    // tiles of the input ring: a tile in use, two in flight
constexpr int kStageOut = 8;   // tiles of outputs written out at once

// The channel's device memory. A barrier waits for the global loads and
// stores its warp has in flight, so no plain load or store may be left in
// flight across the pair's barrier: the inputs come two tiles ahead through
// cp.async (which the barrier does not wait for) into a ring of kStageIn
// tiles, and the outputs go out kStageOut tiles at a time from shared
// memory. Each lane copies and reads only its own samples.
struct GlobalIo {
  const float* x;
  float* out;
  int n;
  float* in_ring;    // kStageIn x 32
  float* out_tiles;  // kStageOut x 32

  __device__ __forceinline__ void copy(int it) const {   // tile it, zero-filled past n
    const int lane = threadIdx.x & 31, i = it * kTile + lane;
    float* dst = in_ring + (it % kStageIn) * kTile + lane;
    const float* src = x + min(i, n - 1);
    const int bytes = i < n ? 4 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src), "r"(bytes) : "memory");
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  // the lags warp, tiles 0, 1, ... in order: tile it's input
  __device__ __forceinline__ float fetch(int it) const {
    if (it == 0) {
      copy(0);
      copy(1);
    }
    asm volatile("cp.async.wait_group 1;" ::: "memory");   // tile it has landed
    const float v = in_ring[(it % kStageIn) * kTile + (threadIdx.x & 31)];
    copy(it + 2);
    return v;
  }
  // the predictor, tiles in order: tile it's output, written out with the
  // kStageOut - 1 before it, or at the last tile
  __device__ __forceinline__ void put(int it, float v) const {
    const int lane = threadIdx.x & 31;
    out_tiles[(it % kStageOut) * kTile + lane] = v;
    const int last = (n - 1) / kTile;
    if (it % kStageOut == kStageOut - 1 || it == last) {
#pragma unroll
      for (int k = 0; k < kStageOut; ++k) {
        const int t = it - it % kStageOut + k, i = t * kTile + lane;
        if (t <= it && i < n) out[i] = out_tiles[k * kTile + lane];
      }
    }
  }
};

__global__ void __launch_bounds__(lms::kWalkThreads, 1) lms_kernel(
    const float* __restrict__ x, const float* __restrict__ w_in,
    const float* __restrict__ win_in, const float* __restrict__ delay,
    const unsigned char* __restrict__ first, float* __restrict__ out,
    float* __restrict__ w_out, float* __restrict__ win_out, int n, float mu,
    int notch) {
  __shared__ lms::Scratch s;
  __shared__ float in_ring[kStageIn * kTile], out_tiles[kStageOut * kTile];
  const int c = blockIdx.x;
  lms::Predictor pr;
  lms::Lags lg;
  if (threadIdx.x < 32)
    pr.load(w_in + c * kTaps);
  else if (threadIdx.x < 64)
    s.load_window(win_in + c * kTaps);
  __syncthreads();
  GlobalIo io{x + (size_t)c * n, out + (size_t)c * n, n, in_ring, out_tiles};
  lms::walk(pr, lg, s, 0, n, io, delay + c * kDelay, *first != 0, mu, notch);
  if (threadIdx.x < 32)
    pr.store(w_out + c * kTaps);
  else if (threadIdx.x < 64)
    s.store_window(win_out + c * kTaps, n);
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
  lms_kernel<<<channels, lms::kWalkThreads, 0, (cudaStream_t)stream>>>(
      x, w_in, win_in, delay, first, out, w_out, win_out, n, mu, notch);
  return (int)cudaGetLastError();
}
