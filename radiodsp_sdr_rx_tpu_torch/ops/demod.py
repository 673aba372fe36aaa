"""Demodulators on complex streams (``radiodsp_sdr_rx_tpu/ops/demod.py``).

The sharded chains (``parallel/stream_shard.py``) work on complex64 streams,
as the JAX ones do: SSB is the real part of the sideband-filtered baseband
(x2, the phasing method), AM the envelope through the DC blocker, SAM the
carrier PLL's in-phase product through the DC blocker. The PLL is
``ops/planar.demod_sam_planar`` on the stream's two planes, the same
per-sample recurrence as the JAX scan: on the card its kernel
``sam_exact``, on the CPU its plain loop. The rest is plain PyTorch, as the
JAX functions are XLA.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from radiodsp_sdr_rx_tpu_torch.ops import planar
from radiodsp_sdr_rx_tpu_torch.ops.iir import dc_blocker

def demod_ssb(z: torch.Tensor) -> torch.Tensor:
    """SSB phasing demod of a sideband-filtered complex baseband: 2 * Re(z)."""
    return 2.0 * z.real


def demod_am(z: torch.Tensor, dc_state: torch.Tensor):
    """AM envelope |z| minus DC. Returns (audio, new_dc_state)."""
    return dc_blocker(z.abs(), dc_state)


class SAMState(NamedTuple):
    phase: torch.Tensor  # f32 rad, PLL phase
    freq: torch.Tensor   # f32 rad/sample, PLL frequency estimate
    dc: torch.Tensor     # (..., 2) DC-blocker carry


def sam_init(device="cpu") -> SAMState:
    return SAMState(phase=torch.zeros((), device=device), freq=torch.zeros((), device=device),
                    dc=torch.zeros(2, device=device))


def demod_sam(z: torch.Tensor, state: SAMState, bw_hz: float = 100.0,
              sample_rate: float = 44117.64706):
    """Synchronous AM of z (..., n) complex64: the second-order carrier PLL
    (natural frequency ``bw_hz``, damping 0.707), its in-phase product
    through the DC blocker. The carries have z's leading shape, () for one
    (n,) stream; ``planar.demod_sam_planar`` runs them as (C,) rows. Returns
    (audio, state')."""
    lead, n = z.shape[:-1], z.shape[-1]
    rows = planar.SAMStatePlanar(state.phase.reshape(-1), state.freq.reshape(-1),
                                 state.dc.reshape(-1, 2))
    audio, st = planar.demod_sam_planar(z.real.reshape(-1, n).contiguous(),
                                        z.imag.reshape(-1, n).contiguous(), rows, bw_hz,
                                        sample_rate)
    return audio.reshape(z.shape), SAMState(st.phase.reshape(lead), st.freq.reshape(lead),
                                            st.dc.reshape(*lead, 2))


def hilbert_bandpass_mask(n: int) -> torch.Tensor:
    """FFT mask of the positive frequencies: ifft(fft(x) * mask) is the
    analytic signal of a real x."""
    mask = torch.zeros(n)
    mask[0] = 1.0
    mask[1:n // 2] = 2.0
    mask[n // 2] = 1.0
    return mask
