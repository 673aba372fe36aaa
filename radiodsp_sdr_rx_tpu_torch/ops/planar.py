"""Planar (split re/im f32) stages of the reference chain (``radiodsp_sdr_rx_tpu/ops/planar.py:32-216``).

What ``models/receiver.rx_chain_batched`` calls, on (C, n) planes: input
balance, the noise blanker, the DDS mix, the overlap-save band-pass (complex
for AM, fused with the SSB demod otherwise), the AM envelope with its DC
blocker, and the PBT stage. These are XLA in JAX and plain PyTorch here; the
products run in full fp32 (``chain_common.matmul_fp32``), the JAX chain's
``Precision.HIGHEST``. The mix and the overlap-save framing are
``ops/chain_common.py``'s, the pieces the fused kernels' plain versions use,
so the reference chain and the kernels frame and mix the stream the same
way. The SAM PLL (``demod_sam_planar``) comes with ROADMAP item 5; its state
type is here because the reference chain's state carries it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from radiodsp_sdr_rx_tpu_torch.ops import nco
from radiodsp_sdr_rx_tpu_torch.ops.chain_common import BLOCK, demod_frames, mix, pbt_frames
from radiodsp_sdr_rx_tpu_torch.ops.iir import dc_blocker, first_order_iir


def nco_mix_planar(xr, xi, phase0, phase_inc):
    """Quadrature DDC mix-down of (C, n) planes by the (C,) int64 DDS words.
    Returns (yr, yi, next_phase0)."""
    n = xr.shape[-1]
    pos = torch.arange(n, dtype=torch.int64, device=xr.device)
    yr, yi = mix(xr, xi, phase0, phase_inc, pos)
    return yr, yi, nco.advance_phase(phase0, n, phase_inc)


def overlap_save_filter_planar(xr, xi, w, tail_r, tail_i):
    """Complex overlap-save band-pass, w (512, 256). Returns (yr, yi,
    new_tail_r, new_tail_i); the tails are the input's last block."""
    c, n = xr.shape
    y = demod_frames(xr, xi, tail_r, tail_i, w)
    return (y[..., :BLOCK].reshape(c, n), y[..., BLOCK:].reshape(c, n),
            xr[:, -BLOCK:], xi[:, -BLOCK:])


def ssb_filter_demod_planar(xr, xi, w_ssb, tail_r, tail_i):
    """Sideband filter + SSB demod as one half-width product, w_ssb (512, 128).
    Returns (audio, new_tail_r, new_tail_i)."""
    audio = demod_frames(xr, xi, tail_r, tail_i, w_ssb).reshape(xr.shape)
    return audio, xr[:, -BLOCK:], xi[:, -BLOCK:]


def pbt_filter_planar(audio, w_pbt, tail):
    """The PBT stage, w_pbt (256, 256) -> [L|R]. Returns (L, R, new_tail)."""
    c, n = audio.shape
    lr = pbt_frames(audio.reshape(c, n // BLOCK, BLOCK), tail, w_pbt)
    return lr[..., :BLOCK].reshape(c, n), lr[..., BLOCK:].reshape(c, n), audio[:, -BLOCK:]


def demod_am_planar(zr, zi, dc_state):
    """AM envelope |z| minus DC (``ops/iir.dc_blocker``). Returns (audio, dc')."""
    return dc_blocker(torch.sqrt(zr * zr + zi * zi), dc_state)


class SAMStatePlanar(NamedTuple):
    phase: torch.Tensor   # (C,) f32 PLL phase
    freq: torch.Tensor    # (C,) f32 PLL frequency
    dc: torch.Tensor      # (C, 2) f32 DC-blocker carry


def sam_init_planar(channels: int = 1, device="cpu") -> SAMStatePlanar:
    return SAMStatePlanar(phase=torch.zeros(channels, device=device),
                          freq=torch.zeros(channels, device=device),
                          dc=torch.zeros(channels, 2, device=device))


def iq_gain_balance_planar(xr, xi, gain):
    return xr, xi * gain


def noise_blanker_planar(xr, xi, avg0, threshold_db=10.0, tau_samples=512.0):
    """Impulse blanker: zero every sample whose magnitude exceeds
    avg*10^(dB/20) + 1e-12, avg the one-pole mean of the magnitude with
    a = exp(-1/tau). The constants are computed in f32, as the JAX chain
    computes them from its f32 parameters. Returns (xr, xi, avg_last)."""
    f32 = dict(dtype=torch.float32, device=xr.device)
    mag = torch.sqrt(xr * xr + xi * xi)
    a = torch.exp(-1.0 / torch.as_tensor(tau_samples, **f32))
    avg, avg_last = first_order_iir(mag, a, 1.0 - a, avg0)
    thresh = torch.pow(10.0, torch.as_tensor(threshold_db, **f32) / 20.0)
    keep = mag <= avg * thresh + 1e-12
    return torch.where(keep, xr, 0.0), torch.where(keep, xi, 0.0), avg_last
