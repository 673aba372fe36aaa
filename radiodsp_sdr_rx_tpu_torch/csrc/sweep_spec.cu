// sweep_spec.cu: the receive chain with spectral-subtraction noise reduction
// folded in, one channel per thread block: six instantiations of
// sweep_chain.cuh's kernels, demod {ssb, am, sam} x noise blanker {off, on},
// ssb and am on sweep_chain_kernel, sam on sam_chain_kernel, whose walking
// warp, alone on its scheduler, walks the PLL a chunk ahead of the rest of
// the chain (the chain, what bounds it and its design are described there).
//
// Replaces _spec_chain_kernel (radiodsp_sdr_rx_tpu/ops/pallas_sweep_spec.py:46,
// wrapper sweep_spec_chain :246), K4, the ssb instantiation without the
// blanker, and _lanes_chain_kernel (ops/pallas_chain_lanes.py:98, wrapper
// sweep_lanes_chain :748) with nr="spectral" (:482-513, 643-644), the other
// five. K4's spectral stage moved into sweep_chain.cuh, so the two TPU kernels
// are one template here: the spectral stage after the chain's PBT, whatever
// the demod and the blanker before it. The TPU kernels run that stage's
// discrete Fourier transform as two dense products (W_fwd 512 x 512, W_inv
// 512 x 256: 6,144 flops a sample, the shape a matrix unit wants); here it is
// a 256-point FFT inside the block (spectral_rows and namespace fft in
// sweep_chain.cuh, about 200 flops a sample), which computes the same
// function because the wrapper (ops/sweep.check_spectral_ops) admits only
// the DFT operators.

#include "sweep_chain.cuh"

// chain_args.cuh's entry
extern "C" int launch_chain(const void* args, int demod, int nb, int channels, int device,
                            void* stream) {
  const ChainArgs& a = *static_cast<const ChainArgs*>(args);
  return launch_variant<Nr::kSpectral>(a, demod, nb, channels, device, stream);
}
