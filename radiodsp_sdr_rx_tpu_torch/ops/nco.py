"""DDS phase words of the digital LO.

The phase accumulator is a uint32 fraction of a cycle, as in a hardware DDS:
``phase[n] = phase0 + n * inc`` with wrap-around, drift-free for any stream
length (``radiodsp_sdr_rx_tpu/ops/nco.py:26-34``). PyTorch on the CPU has no
uint32 add, so the port holds phase words in int64 and wraps with
``& 0xFFFFFFFF``; the kernel reads them as ``uint32_t``.
"""

from __future__ import annotations

import numpy as np
import torch

_TWO_POW_32 = 4294967296.0
PHASE_MASK = 0xFFFFFFFF


def freq_to_phase_inc(freq_hz, sample_rate: float) -> np.uint32:
    """Frequency in Hz -> uint32 phase increment (cycles * 2^32), float64."""
    cycles = np.asarray(freq_hz, np.float64) / sample_rate
    frac = cycles - np.floor(cycles)
    return (np.round(frac * _TWO_POW_32).astype(np.int64) % (1 << 32)).astype(np.uint32)


def bank_phase_incs(config, freqs_hz) -> np.ndarray:
    """(C,) uint32 DDS increments that tune each channel of a bank, at RF
    frequencies ``freqs_hz``, to baseband (less the mode's tuning offset)."""
    return np.stack([
        freq_to_phase_inc(f - config.tuning_offset - config.capture_center_freq,
                          config.sample_rate)
        for f in np.asarray(freqs_hz, np.float64)])


def advance_phase(phase: torch.Tensor, n: int, inc: torch.Tensor) -> torch.Tensor:
    """Phase words after ``n`` samples: (phase + n*inc) mod 2^32, in int64."""
    return (phase + (n % (1 << 32)) * inc) & PHASE_MASK
