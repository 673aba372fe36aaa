"""radiodsp_sdr_rx_tpu_torch: the receiver ported to PyTorch and CUDA (Hopper).

The JAX package ``radiodsp_sdr_rx_tpu`` is the reference; this package never
imports it, nor JAX. Host-side design (config, FIR design, operators, AGC
presets) is a numpy copy; each Pallas kernel of the JAX package becomes a CUDA
kernel under ``csrc/``, built with ``nvcc`` at first use (utils/build.py),
beside a plain PyTorch version of the same function that runs on the CPU.

Layers, from the entry point down:
  cli.py, __main__.py  the app: ``python -m radiodsp_sdr_rx_tpu_torch``
                   demod / scope / stream / tui / scan / info on the card;
                   ``cli.main(argv, device="cpu")`` on the CPU
  models/appliance.py, models/controls.py, models/vfo.py  the appliance:
                   UI events through the control plane retune or rebuild
                   the receiver; the scopes beside it
  models/streaming.py  StreamingReceiver: the native ring feeding the
                   receiver (and the scopes) block by block
  models/fused.py  FusedSSBBank: state threading; sweep backend one launch
                   per segment (noise blanker included), staged backend two;
                   FusedAMBank: one launch per segment (blanker included);
                   FusedNRBank: spectral NR folded into one launch per
                   segment, or DNR / notch / spectral staged;
                   FusedSAMBank: staged (the PLL kernel, then PBT), or
                   folded into one launch per segment, up to 128 channels
                   on the lanes chain, wider banks on the wide chain
  models/receiver.py  Receiver: the single-channel receiver the CLI runs
                   (I/Q swap, I2S-slip repair with hysteresis, ops/
                   preprocessor.py); ReceiverBank: the reference bank chain;
                   both plain PyTorch stages (ops/planar.py with the exact
                   SAM PLL and the conv-first stages, ops/iir.py, ops/agc.py,
                   ops/qformat.py), any fft_length, the LMS stages on a kernel
  ops/sweep.py     sweep_full_chain, sweep_am_chain, sweep_sam_chain: kernel
                   wrappers, plain versions, launch counts; sweep_mix_filter_
                   demod: mix + band-pass + SSB demod from a stream start (K8)
  ops/sam.py       sam_pll_run: the SAM PLL kernel (K5); the PLL step and
                   re-seed schedule the SAM chains share
  ops/sam_wide.py  sweep_sam_wide: the SAM chain for wide banks (K7)
  ops/sweep_spec.py  sweep_spec_chain: the chain with spectral NR (K4)
  ops/planar.py, ops/spectral_sub.py  the reference chain's stages, the
                   spectral subtraction's DFT operators and floor tracking
  ops/staged.py    fused_mix_filter_demod, pbt_filter: the staged kernels
  ops/lms_bank.py  lms_nr_run_bank: the LMS kernel (ops/lms.py: its state)
  ops/agc.py       agc_run: the staged backend's and ReceiverBank's AGC
  ops/noise_blanker.py, ops/fastconv.py  the complex-IQ blanker and
                   overlap-save filters (the FFT form a cross-check)
  utils/siggen.py, utils/scenes.py  synthetic signals and band scenes
  ops/chain_common.py  the mix, framings and argument checks the plain
                   versions, wrappers and the reference chain share
  models/metrics.py  analyze: the scopes (panadapter, waterfall, S-meter,
                   audio scope) on the device of their inputs, no host sync
                   (ops/analyzers.py, ops/iir.py's biquad scan,
                   utils/smeter.py, utils/display.py with the ASCII renderers)
  models/channelized.py  ChannelizedBank: the PFB front end and per-channel
                   baseband / AM / power / SSB (ops/channelizer.py,
                   ops/decimate.py's DDC)
  utils/io.py, utils/native_io.py, utils/audio_sink.py, utils/checkpoint.py,
  utils/profiling.py  the host runtime: WAV and raw IQ files, the native IQ
                   ring (csrc/rdsp_io.cpp, built with g++), the audio sink,
                   checkpoints that either package loads, torch.profiler
                   traces and the port's spans
  csrc/*.cu        the kernels (shared device code in csrc/chain_common.cuh
                   and, for the SAM PLL, csrc/sam_pll.cuh)
  models/config.py, models/receiver.py, ops/{fir_design,operators,agc,nco}.py
                   host-side design, bit-equal to the JAX package's
"""

from radiodsp_sdr_rx_tpu_torch.version import __version__

# The reference's invariants: the exact Teensy AUDIO_SAMPLE_RATE_EXACT of all
# its frequency arithmetic (RDSP_convolutional.h:35), the audio block
# (:34) and the overlap-save FFT length (:36).
SAMPLE_RATE = 44117.64706  # Hz
BLOCK_SIZE = 128           # samples per audio block
FFT_LENGTH = 256           # overlap-save FFT length

from radiodsp_sdr_rx_tpu_torch.models.config import (  # noqa: E402
    AGCMode,
    AudioFilter,
    DemodMode,
    FilterWindow,
    NRMode,
    ReceiverConfig,
)
from radiodsp_sdr_rx_tpu_torch.models.fused import (  # noqa: E402
    FusedAMBank,
    FusedAMBankState,
    FusedBankState,
    FusedNRBank,
    FusedNRBankState,
    FusedSAMBank,
    FusedSAMBankState,
    FusedSSBBank,
)
from radiodsp_sdr_rx_tpu_torch.models.receiver import (  # noqa: E402
    Receiver,
    ReceiverBank,
    ReceiverState,
)

__all__ = ["__version__", "SAMPLE_RATE", "BLOCK_SIZE", "FFT_LENGTH",
           "AGCMode", "AudioFilter", "DemodMode", "FilterWindow", "FusedAMBank", "FusedAMBankState", "FusedBankState",
           "FusedNRBank", "FusedNRBankState", "FusedSAMBank", "FusedSAMBankState",
           "FusedSSBBank", "NRMode", "Receiver", "ReceiverBank", "ReceiverConfig",
           "ReceiverState"]
