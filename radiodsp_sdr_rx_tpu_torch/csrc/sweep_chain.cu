// sweep_chain.cu: the receive chain without an NR stage, one channel per
// thread block: five instantiations of sweep_chain.cuh's kernel (the chain,
// what bounds it and its design are described there), the AM chain's two on
// a cluster of two blocks per channel (am_pair_kernel), and the SSB chain
// without the blanker, with and without R, on the tensor cores' pre-laid
// feed (ssb_fed_kernel).
//
// Replaces _chain_kernel (radiodsp_sdr_rx_tpu/ops/pallas_sweep.py:261) in five
// instantiations, demod x noise blanker x R output, and the SAM stage of
// _lanes_chain_kernel (ops/pallas_chain_lanes.py:98, demod "sam", nr "none",
// wrapper sweep_lanes_chain :748) in two more:
//   sweep_chain_ssb      demod="ssb"            (wrapper sweep_full_chain :628;
//                        ssb_fed_kernel<true>, launch_ssb below)
//   sweep_chain_ssb_nb   demod="ssb", nb=true   (:327-331, 361-363, 386-403)
//   sweep_chain_am       demod="am"             (wrapper sweep_am_chain :695;
//                                                :339-341, 357-360, 418-447)
//   sweep_chain_am_nb    demod="am", nb=true
//                        (both also as am_pair_kernel: the same chain on a
//                        cluster of two blocks per channel, launch_am below)
//   sweep_chain_ssb_mono demod="ssb", emit_r=False (:482-489, 558-561): R is
//                        neither computed into the output nor stored
//                        (ssb_fed_kernel<false>)
//   sweep_chain_sam      pallas_chain_lanes demod="sam", nr="none" (:413-455,
//                        :620-627): the AM chain with the carrier PLL of
//                        sam_pll.cuh in place of the envelope
//   sweep_chain_sam_nb   the same with the noise blanker

#include "sweep_chain.cuh"

// chain_args.cuh's entry for the instantiations of sweep_chain_kernel here:
// every demod with the blanker, AM and SAM without; cudaErrorInvalidValue
// for the SSB chain without the blanker, which launch_ssb runs.
extern "C" int launch_chain(const void* args, int demod, int nb, int channels, int device,
                            void* stream) {
  const ChainArgs& a = *static_cast<const ChainArgs*>(args);
  return launch_variant<Nr::kNone>(a, demod, nb, channels, device, stream);
}

// The SSB chain without the blanker (ssb_fed_kernel), emit_r != 0 with R
// (sweep_chain_ssb), else without (sweep_chain_ssb_mono, out_r unused), its
// products fed from the operators' images band and pbt
// (ops/tf32x3.tf32_image: w_ssb's, and w_pbt's or its L half's), one block
// a channel.
extern "C" int launch_ssb(const void* args, const float* band, const float* pbt, int emit_r,
                          int channels, int device, void* stream) {
  const ChainArgs& a = *static_cast<const ChainArgs*>(args);
  const FeedArgs f{band, pbt};
  return emit_r ? launch_fed<true>(a, f, channels, device, stream)
                : launch_fed<false>(a, f, channels, device, stream);
}

// The AM chain (nb != 0: with the blanker) on `split` blocks per channel: 1
// sweep_chain_kernel, 2 am_pair_kernel on clusters of two blocks;
// cudaErrorInvalidValue for another split.
extern "C" int launch_am(const void* args, int nb, int split, int channels, int device,
                         void* stream) {
  const ChainArgs& a = *static_cast<const ChainArgs*>(args);
  if (split == 1) return launch_variant<Nr::kNone>(a, 1, nb, channels, device, stream);
  if (split != 2) return (int)cudaErrorInvalidValue;
  return nb ? launch_pair<true>(a, channels, device, stream)
            : launch_pair<false>(a, channels, device, stream);
}

// How many two-block clusters of the AM pair kernel device `device` holds at
// once, or minus the cudaError_t of the query.
extern "C" int am_pair_clusters(int nb, int device) {
  return nb ? pair_clusters<true>(device) : pair_clusters<false>(device);
}
