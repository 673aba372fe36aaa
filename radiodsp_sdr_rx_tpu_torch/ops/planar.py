"""Planar (split re/im f32) stages of the reference chain (``radiodsp_sdr_rx_tpu/ops/planar.py:32-336``).

What ``models/receiver.rx_chain_batched`` calls, on (C, n) planes: input
balance, the noise blanker, the DDS mix, the overlap-save band-pass (complex
for AM, fused with the SSB demod otherwise), the AM envelope with its DC
blocker, the PBT stage and the spectral subtraction (its DFTs as planar
matrix products). These are XLA in JAX and plain PyTorch here; the
products run in full fp32 (``chain_common.matmul_fp32``), the JAX chain's
``Precision.HIGHEST``. The mix and the overlap-save framing are
``ops/chain_common.py``'s, the pieces the fused kernels' plain versions use,
so the reference chain and the kernels frame and mix the stream the same
way. ``demod_sam_planar`` is the exact SAM PLL (cos, sin, atan2 and the
phase wrapped by ``torch.remainder``, as ``jnp.mod``), one vectorised step per
sample over the channels, then the DC blocker.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.ops import nco, sam
from radiodsp_sdr_rx_tpu_torch.ops.chain_common import (
    BLOCK,
    demod_frames,
    matmul_fp32,
    mix,
    pbt_frames,
)
from radiodsp_sdr_rx_tpu_torch.ops.iir import dc_blocker, first_order_iir
from radiodsp_sdr_rx_tpu_torch.ops.spectral_sub import (
    UNDER_FLOOR_GAIN,
    VAD_END_BIN,
    VAD_START_BIN,
    floor_track,
)


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


def demod_sam_planar(zr, zi, state: SAMStatePlanar, bw_hz: float = 100.0,
                     sample_rate: float = 44117.64706):
    """Synchronous AM of (C, n) band-passed IQ: the second-order carrier PLL
    (``ops/planar.py:154-184`` of the JAX package), its in-phase product
    through the DC blocker. Returns (audio, state')."""
    kp, ki, max_freq = sam.pll_gains(bw_hz, sample_rate)
    two_pi = 2.0 * np.pi
    phase, freq = state.phase, state.freq
    vr = torch.empty_like(zr)
    for t in range(zr.shape[-1]):
        cr, ci = torch.cos(phase), torch.sin(phase)
        vr[..., t] = zr[..., t] * cr + zi[..., t] * ci
        err = torch.atan2(zi[..., t] * cr - zr[..., t] * ci, vr[..., t])
        freq = (freq + ki * err).clamp(-max_freq, max_freq)
        phase = torch.remainder(phase + freq + kp * err, two_pi)
    audio, dc = dc_blocker(vr, state.dc)
    return audio, SAMStatePlanar(phase=phase, freq=freq, dc=dc)


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


# ---------------- spectral subtraction (DFT as matrix products) ----------------

def dft_matrices(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(n, n) f32 cos/sin DFT matrices, S = x @ (C - jS) == FFT(x), built in
    float64."""
    k = np.arange(n)
    w = 2.0 * np.pi * np.outer(k, k) / n
    return np.cos(w).astype(np.float32), np.sin(w).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _split_dft_consts(n: int) -> tuple[np.ndarray, ...]:
    """f32 constants of one radix-2 decimation-in-time level of the n-point
    DFT: the (n/2)-point cos/sin matrices and the first-level twiddles,
    built in float64. Read-only: every call shares them."""
    m = n // 2
    k = np.arange(m)
    w = 2.0 * np.pi * np.outer(k, k) / m
    tw = 2.0 * np.pi * k / n
    out = tuple(a.astype(np.float32) for a in (np.cos(w), np.sin(w), np.cos(tw), np.sin(tw)))
    for a in out:
        a.flags.writeable = False
    return out


def planar_dft_split(xr, xi, n: int):
    """n-point DFT of planar complex frames (..., n) by one radix-2 DIT level:
    eight (n/2)-point products in place of four n-point ones, half the
    multiply-adds, the same function as (xr + j xi) @ (C_n - j S_n) up to f32
    rounding. Returns (re, im)."""
    c2, s2, twc, tws = (torch.tensor(a, device=xr.device) for a in _split_dft_consts(n))
    er_, or_ = xr[..., 0::2], xr[..., 1::2]      # even and odd samples
    ei_, oi_ = xi[..., 0::2], xi[..., 1::2]
    mm = matmul_fp32
    e_r = mm(er_, c2) + mm(ei_, s2)
    e_i = mm(ei_, c2) - mm(er_, s2)
    o_r = mm(or_, c2) + mm(oi_, s2)
    o_i = mm(oi_, c2) - mm(or_, s2)
    t_r = twc * o_r + tws * o_i                  # twiddle W_n^k = e^{-2 pi j k / n}
    t_i = twc * o_i - tws * o_r
    return (torch.cat([e_r + t_r, e_r - t_r], dim=-1),
            torch.cat([e_i + t_i, e_i - t_i], dim=-1))


def _frames(x, tail):
    """Overlap-save frames [prev | cur] (C, rows, 256) of x (C, n) and its
    tail (C, 128)."""
    c, n = x.shape
    x = x.reshape(c, n // BLOCK, BLOCK)
    return torch.cat([torch.cat([tail[:, None], x[:, :-1]], dim=1), x], dim=-1)


def spectral_subtract_planar(l, r, nr_level, nfloor0, dft_cos, dft_sin, tail_l, tail_r,
                             split_dft: bool = True):
    """The backup engine's spectral subtraction on (C, n) stereo planes, the
    DFTs as planar products (z = L + jR per frame, the reference layout).
    ``split_dft=True`` runs both transforms through ``planar_dft_split``
    (dft_cos/dft_sin then give only the size); False multiplies by the
    direct n x n matrices. The floor is tracked across frames, clamped at 0.
    Returns (L', R', nfloor_last, new_tail_l, new_tail_r)."""
    n = dft_cos.shape[0]
    if n != 2 * BLOCK:
        raise ValueError(f"the port frames {BLOCK}-sample blocks: fft length 256, got {n}")
    fl, fr_ = _frames(l, tail_l), _frames(r, tail_r)
    if split_dft:
        sr, si = planar_dft_split(fl, fr_, n)
    else:
        sr = matmul_fp32(fl, dft_cos) + matmul_fp32(fr_, dft_sin)
        si = matmul_fp32(fr_, dft_cos) - matmul_fp32(fl, dft_sin)
    mag = torch.sqrt(sr * sr + si * si)

    floor_est = mag[..., VAD_START_BIN:VAD_END_BIN + 1].sum(-1) / (VAD_END_BIN - VAD_START_BIN)
    floor_est = floor_est * float(np.float32(nr_level) * np.float32(1.5))
    nfloor = floor_track(floor_est, nfloor0).clamp(min=0.0)

    nf = nfloor[..., None]
    scale = torch.where(mag <= nf, UNDER_FLOOR_GAIN, 1.0 - nf / mag.clamp(min=1e-20))
    # the subtracted magnitude with the original phase == the scaled bin
    sr2, si2 = sr * scale, si * scale
    # inverse DFT: y = (sr2 + j si2) @ (C + jS) / n = conj(DFT(conj(spec))) / n
    if split_dft:
        ar, ai = planar_dft_split(sr2, -si2, n)
        yl, yr = ar * (1.0 / n), -ai * (1.0 / n)
    else:
        yl = (matmul_fp32(sr2, dft_cos) - matmul_fp32(si2, dft_sin)) * (1.0 / n)
        yr = (matmul_fp32(si2, dft_cos) + matmul_fp32(sr2, dft_sin)) * (1.0 / n)
    out_l = yl[..., BLOCK:].reshape(l.shape)
    out_r = yr[..., BLOCK:].reshape(r.shape)
    return (out_l, out_r, nfloor[..., -1].contiguous(), l[:, -BLOCK:].contiguous(),
            r[:, -BLOCK:].contiguous())
