"""DDS phase words of the digital LO.

The phase accumulator is a uint32 fraction of a cycle, as in a hardware DDS:
``phase[n] = phase0 + n * inc`` with wrap-around, drift-free for any stream
length (``radiodsp_sdr_rx_tpu/ops/nco.py:26-34``). PyTorch on the CPU has no
uint32 add, so the port holds phase words in int64 and wraps with
``& 0xFFFFFFFF``; the kernel reads them as ``uint32_t``.

``nco_phases``, ``nco_phase_advance`` and ``nco_mix`` are the complex-stream
LO of ``radiodsp_sdr_rx_tpu/ops/nco.py:37-70``, which the sharded chains
(``parallel/stream_shard.py``) mix with. Unlike the kernels' mix
(``ops/chain_common.mix``), ``nco_mix`` converts the uint32 word itself to
float32, as the JAX function does: the angle lies in [0, 2*pi).
"""

from __future__ import annotations

import numpy as np
import torch

_TWO_POW_32 = 4294967296.0
_PHASE_SCALE = np.float32(2.0 * np.pi / _TWO_POW_32)
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


def mul_u32(a, b):
    """(a * b) mod 2^32 of words in [0, 2^32) (ints or int64 tensors),
    exact: b is split into 16-bit halves so no product leaves int64."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & PHASE_MASK


def advance_phase(phase: torch.Tensor, n: int, inc: torch.Tensor) -> torch.Tensor:
    """Phase words after ``n`` samples: (phase + n*inc) mod 2^32, in int64."""
    return (phase + (n % (1 << 32)) * inc) & PHASE_MASK


def nco_phases(n: int, phase0, phase_inc) -> torch.Tensor:
    """Phase words phase0 + [0..n) * inc (uint32 wrap), int64 (..., n) for
    (...,) words."""
    phase0 = torch.as_tensor(phase0, dtype=torch.int64)
    idx = torch.arange(n, dtype=torch.int64, device=phase0.device)
    inc = torch.as_tensor(phase_inc, dtype=torch.int64, device=phase0.device)
    return (phase0[..., None] + idx * inc[..., None]) & PHASE_MASK


def nco_phase_advance(phase0, phase_inc, n) -> torch.Tensor:
    """The phase carry after n samples (uint32 wrap), int64."""
    phase0 = torch.as_tensor(phase0, dtype=torch.int64)
    inc = torch.as_tensor(phase_inc, dtype=torch.int64, device=phase0.device)
    return (phase0 + mul_u32(int(n) % (1 << 32), inc)) & PHASE_MASK


def nco_mix(x: torch.Tensor, phase0, phase_inc, conj: bool = True):
    """Mix a complex64 stream x (..., n) with the LO exp(-+j*2*pi*phase[n]/2^32);
    phase0 and phase_inc are uint32 words as int64 (scalars or (...,)).
    ``conj`` mixes down by +inc, the usual DDC direction. Returns (y,
    next_phase0)."""
    phase0 = torch.as_tensor(phase0, dtype=torch.int64, device=x.device)
    phases = nco_phases(x.shape[-1], phase0, phase_inc)
    ang = phases.to(torch.float32) * float(_PHASE_SCALE)
    lo = torch.complex(torch.cos(ang), -torch.sin(ang) if conj else torch.sin(ang))
    return x * lo, nco_phase_advance(phase0, phase_inc, x.shape[-1])
