// sweep_notch.cu: the receive chain with the LMS auto-notch folded in, one
// channel per thread block: six instantiations of sweep_chain.cuh's kernel,
// demod {ssb, am, sam} x noise blanker {off, on} (the chain, what bounds it
// and its design are described there).
//
// Replaces _lanes_chain_kernel (radiodsp_sdr_rx_tpu/ops/pallas_chain_lanes.py:98,
// wrapper sweep_lanes_chain :748) with nr="notch" (:635-636: the LMS error between
// the demod and the AGC), the LMS in the grouped exact algebra of the TPU's macro
// (ops/pallas_lms.py:127, 230), laid out for one warp in lms_step.cuh: 16
// samples a group, the lag products slid one sample at a time and summed
// afresh every 128, each group's triangular system inverted off the
// weights' path: warps 0-2 walk while the other five wait.

#include "sweep_chain.cuh"

// chain_args.cuh's entry
extern "C" int launch_chain(const void* args, int demod, int nb, int channels, int device,
                            void* stream) {
  const ChainArgs& a = *static_cast<const ChainArgs*>(args);
  return launch_variant<Nr::kNotch>(a, demod, nb, channels, device, stream);
}
