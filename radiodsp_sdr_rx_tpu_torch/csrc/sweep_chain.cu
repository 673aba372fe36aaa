// sweep_chain.cu: the receive chain without an NR stage, one channel per
// thread block: seven instantiations of sweep_chain.cuh's kernel (the chain,
// what bounds it and its design are described there).
//
// Replaces _chain_kernel (radiodsp_sdr_rx_tpu/ops/pallas_sweep.py:261) in five
// instantiations, demod x noise blanker x R output, and the SAM stage of
// _lanes_chain_kernel (ops/pallas_chain_lanes.py:98, demod "sam", nr "none",
// wrapper sweep_lanes_chain :748) in two more:
//   sweep_chain_ssb      demod="ssb"            (wrapper sweep_full_chain :628)
//   sweep_chain_ssb_nb   demod="ssb", nb=true   (:327-331, 361-363, 386-403)
//   sweep_chain_am       demod="am"             (wrapper sweep_am_chain :695;
//                                                :339-341, 357-360, 418-447)
//   sweep_chain_am_nb    demod="am", nb=true
//   sweep_chain_ssb_mono demod="ssb", emit_r=False (:482-489, 558-561): R is
//                        neither computed into the output nor stored
//   sweep_chain_sam      pallas_chain_lanes demod="sam", nr="none" (:413-455,
//                        :620-627): the AM chain with the carrier PLL of
//                        sam_pll.cuh in place of the envelope
//   sweep_chain_sam_nb   the same with the noise blanker

#include "sweep_chain.cuh"

// chain_args.cuh's entry: a null out_r selects the ssb chain without R (no
// blanker), cudaErrorInvalidValue with another demod or the blanker.
extern "C" int launch_chain(const void* args, int demod, int nb, int channels, int device,
                            void* stream) {
  const ChainArgs& a = *static_cast<const ChainArgs*>(args);
  if (a.out_r == nullptr)
    return demod == 0 && !nb
               ? launch<Demod::kSSB, false, Nr::kNone, false>(a, channels, device, stream)
               : (int)cudaErrorInvalidValue;
  return launch_variant<Nr::kNone>(a, demod, nb, channels, device, stream);
}
