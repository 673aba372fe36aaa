// chain_args.cuh: the arguments of a receive-chain launch, the one host
// interface of the chain kernels (sweep_chain.cuh's instantiations and
// sam_wide.cu). Each source exports
//   extern "C" int launch_chain(const void* args, int variant, int nb,
//                               int channels, int device, void* stream);
// with args pointing to a ChainArgs in host memory (ops/sweep._ChainArgs
// mirrors it field for field: a field goes into both or neither), variant
// the demod (0 ssb, 1 am, 2 sam) or for sam_wide.cu the channels per block,
// nb != 0 the noise blanker; it returns the cudaError_t of the launch.

#pragma once

#include <cuda_runtime.h>

#include "sam_pll.cuh"

namespace {

// Every argument of a launch; the pointers a variant does not use may be
// null. Device pointers to contiguous tensors: xr, xi, out_l, out_r (C, n);
// inc, phase0 (C,) int64; w_band (512, 128) ssb or (512, 256) am/sam; w_pbt
// (256, 256); tail_r, tail_i, atail_in/out, nb_mask0/out, stl0/out,
// str0/out (C, 128); env0/out, nb_avg0/out, nfl0/out (C,); dc0/out (C, 2);
// pll0/out (2, C); lms_w0/out, lms_win0/out (C, 96); lms_delay0/out
// (C, 128); lms_first one byte, nonzero for the stream's first segment;
// fft_tw (2, 256): the spectral stage's FFT twiddles W^j = exp(-2 pi i j /
// 256), [cos | -sin], float64 rounded to float32.
struct ChainArgs {
  const float* xr;
  const float* xi;
  const long long* inc;
  const long long* phase0;
  const float* w_band;
  const float* w_pbt;
  const float* tail_r;
  const float* tail_i;
  const float* atail_in;
  const float* env0;
  float* out_l;
  float* out_r;
  float* atail_out;
  float* env_out;
  const float* nb_avg0;
  const float* nb_mask0;
  float* nb_avg_out;
  float* nb_mask_out;
  const float* dc0;
  float* dc_out;
  const float* pll0;
  float* pll_out;
  const float* lms_w0;
  const float* lms_win0;
  const float* lms_delay0;
  const unsigned char* lms_first;
  float* lms_w_out;
  float* lms_win_out;
  float* lms_delay_out;
  const float* fft_tw;
  const float* nfl0;
  const float* stl0;
  const float* str0;
  float* nfl_out;
  float* stl_out;
  float* str_out;
  double release;     // AGC release per sample
  double nb_a;        // the blanker's pole exp(-1/tau)
  int n;              // samples per channel, a multiple of 128
  int agc_enabled;
  float target;
  float max_gain;
  float out_gain;
  float g_i;          // input gain
  float g_q;          // input gain * IQ balance
  float nb_thresh;    // 10^(dB/20)
  float mu;           // the LMS step size
  float nr_gain;      // the spectral floor multiplier level * 1.5 / 150
  PllGains gains;
  Reseed reseed;
};

}  // namespace
