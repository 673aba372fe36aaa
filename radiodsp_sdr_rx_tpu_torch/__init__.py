"""radiodsp_sdr_rx_tpu_torch: the receiver ported to PyTorch and CUDA (Hopper).

The JAX package ``radiodsp_sdr_rx_tpu`` is the reference; this package never
imports it, nor JAX. Host-side design (config, FIR design, operators, AGC
presets) is a numpy copy; each Pallas kernel of the JAX package becomes a CUDA
kernel under ``csrc/``, built with ``nvcc`` at first use (utils/build.py),
beside a plain PyTorch version of the same function that runs on the CPU.

Layers, from the entry point down:
  models/fused.py  FusedSSBBank: state threading; sweep backend one launch
                   per segment (noise blanker included), staged backend two
  ops/sweep.py     sweep_full_chain: kernel wrapper, plain version, launch counts
  ops/staged.py    fused_mix_filter_demod, pbt_filter: the staged kernels
  ops/agc.py       agc_run: the staged backend's AGC, plain PyTorch
  ops/chain_common.py  the mix, framings and argument checks both
                   backends' plain versions and wrappers share
  csrc/*.cu        the kernels (shared device code in csrc/chain_common.cuh)
  models/config.py, models/receiver.py, ops/{fir_design,operators,agc,nco}.py
                   host-side design, bit-equal to the JAX package's
"""

from radiodsp_sdr_rx_tpu_torch.models.config import (
    AGCMode,
    DemodMode,
    ReceiverConfig,
)
from radiodsp_sdr_rx_tpu_torch.models.fused import FusedBankState, FusedSSBBank

__all__ = ["AGCMode", "DemodMode", "FusedBankState", "FusedSSBBank", "ReceiverConfig"]
