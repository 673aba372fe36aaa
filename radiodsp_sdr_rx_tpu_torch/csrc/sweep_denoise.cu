// sweep_denoise.cu: the receive chain with the LMS denoiser folded in, one
// channel per thread block: six instantiations of sweep_chain.cuh's kernel,
// demod {ssb, am, sam} x noise blanker {off, on} (the chain, what bounds it
// and its design are described there).
//
// Replaces _lanes_chain_kernel (radiodsp_sdr_rx_tpu/ops/pallas_chain_lanes.py:98,
// wrapper sweep_lanes_chain :748) with nr="denoise" (:639-642: the post-PBT LMS
// predictor y, x1.1, mono), the LMS step of lms_step.cuh in place of the TPU's
// grouped macro (ops/pallas_lms.py:127, 230), which is the same NLMS
// recurrence reassociated for the TPU's lanes.

#include "sweep_chain.cuh"

// chain_args.cuh's entry
extern "C" int launch_chain(const void* args, int demod, int nb, int channels, int device,
                            void* stream) {
  const ChainArgs& a = *static_cast<const ChainArgs*>(args);
  return launch_variant<Nr::kDenoise>(a, demod, nb, channels, device, stream);
}
