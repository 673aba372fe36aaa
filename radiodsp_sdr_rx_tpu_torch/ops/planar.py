"""Planar (split re/im f32) stages of the reference chain (``radiodsp_sdr_rx_tpu/ops/planar.py``).

What ``models/receiver.rx_chain_batched`` calls, on (C, n) planes: input
balance, the noise blanker, the DDS mix, the overlap-save band-pass (complex
for AM and the conv-first stage, fused with the SSB demod otherwise), the
AM envelope with its DC blocker, the PBT stage, the spectral subtraction and
the conv-first inline denoise (their DFTs as planar matrix products). These
are XLA in JAX and plain PyTorch here; the products run in full fp32
(``chain_common.matmul_fp32``), the JAX chain's ``Precision.HIGHEST``. The
mix is ``ops/chain_common.py``'s, the one the fused kernels' plain versions
use. The filters frame by their operator's shape, so any ``fft_length``
(block = fft_length / 2 samples; n a multiple of it) runs, as in JAX.
``demod_sam_planar`` is the exact SAM PLL (cos, sin, atan2 and the
phase wrapped by ``torch.remainder``, as ``jnp.mod``), then the DC blocker,
the JAX package's ``lax.scan`` (:154-186). Its PLL, ``sam_exact``, launches ``csrc/sam.cu``'s
kernel of that name for CUDA tensors, which walks the recurrence with the
plain loop's operations and gives its bits, or raises; CPU tensors run
``sam_exact_plain``, one vectorised step per sample over the channels
(host-bound on the card: about ten launches a sample). ``LAUNCHES`` counts
``sam_exact``'s launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.ops import nco, sam
from radiodsp_sdr_rx_tpu_torch.ops.chain_common import (
    check_launch, check_tensors, matmul_fp32, mix)
from radiodsp_sdr_rx_tpu_torch.ops.fastconv import frame_overlap_save
from radiodsp_sdr_rx_tpu_torch.ops.iir import dc_blocker, first_order_iir
from radiodsp_sdr_rx_tpu_torch.ops.spectral_sub import (
    INLINE_END_BIN,
    INLINE_MULT,
    INLINE_START_BIN,
    UNDER_FLOOR_GAIN,
    VAD_END_BIN,
    VAD_START_BIN,
    floor_track,
)
from radiodsp_sdr_rx_tpu_torch.utils import build
from radiodsp_sdr_rx_tpu_torch.utils.profiling import span

LAUNCHES = 0   # sam_exact


def nco_mix_planar(xr, xi, phase0, phase_inc):
    """Quadrature DDC mix-down of (C, n) planes by the (C,) int64 DDS words.
    Returns (yr, yi, next_phase0)."""
    n = xr.shape[-1]
    pos = torch.arange(n, dtype=torch.int64, device=xr.device)
    yr, yi = mix(xr, xi, phase0, phase_inc, pos)
    return yr, yi, nco.advance_phase(phase0, n, phase_inc)


# the JAX package's name for the overlap-save framing (ops/decimate.py frames by it)
frame_planar = frame_overlap_save


def _frames(x, tail):
    """Overlap-save frames [prev | cur] (C, rows, 2*block) of x (C, n) and
    its tail (C, block), block = fft_length / 2, n a multiple of block."""
    block = tail.shape[-1]
    if x.shape[-1] % block:
        raise ValueError(f"the segment length {x.shape[-1]} must be a multiple of "
                         f"fft_length/2 = {block}")
    return frame_overlap_save(x, tail, block)


def _filter(xr, xi, tail_r, tail_i, w):
    """[frames of xr | frames of xi] (C, rows, 2F) @ w (2F, m)."""
    return matmul_fp32(torch.cat([_frames(xr, tail_r), _frames(xi, tail_i)], dim=-1), w)


def overlap_save_filter_planar(xr, xi, w, tail_r, tail_i):
    """Complex overlap-save band-pass, w (2F, F) with F = fft_length. Returns
    (yr, yi, new_tail_r, new_tail_i); the tails are the input's last block."""
    c, n = xr.shape
    block = w.shape[1] // 2
    y = _filter(xr, xi, tail_r, tail_i, w)
    return (y[..., :block].reshape(c, n), y[..., block:].reshape(c, n),
            xr[:, -block:], xi[:, -block:])


def ssb_filter_demod_planar(xr, xi, w_ssb, tail_r, tail_i):
    """Sideband filter + SSB demod as one half-width product, w_ssb (2F, F/2).
    Returns (audio, new_tail_r, new_tail_i)."""
    block = w_ssb.shape[1]
    audio = _filter(xr, xi, tail_r, tail_i, w_ssb).reshape(xr.shape)
    return audio, xr[:, -block:], xi[:, -block:]


def pbt_filter_planar(audio, w_pbt, tail):
    """The PBT stage, w_pbt (F, F) -> [L|R]. Returns (L, R, new_tail)."""
    c, n = audio.shape
    block = w_pbt.shape[0] // 2
    lr = matmul_fp32(_frames(audio, tail), w_pbt)
    return lr[..., :block].reshape(c, n), lr[..., block:].reshape(c, n), audio[:, -block:]


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


def _check_sam(zr, zi, phase, freq, dc=None) -> None:
    if zr.dim() != 2 or zr.shape[1] == 0:
        raise ValueError(f"zr must be (C, n) with n > 0, got {tuple(zr.shape)}")
    c, n = zr.shape
    check_tensors({"zr": (zr, (c, n), torch.float32), "zi": (zi, (c, n), torch.float32),
                   "phase": (phase, (c,), torch.float32), "freq": (freq, (c,), torch.float32),
                   **({} if dc is None else {"dc": (dc, (c, 2), torch.float32)})}, zr.device)


def sam_exact_plain(zr, zi, phase, freq, bw_hz: float = 100.0,
                    sample_rate: float = 44117.64706):
    """Plain PyTorch version of ``sam_exact``: one vectorised step per sample,
    the operations the kernel repeats."""
    _check_sam(zr, zi, phase, freq)
    kp, ki, max_freq = sam.pll_gains(bw_hz, sample_rate)
    two_pi = 2.0 * np.pi
    vr = torch.empty_like(zr)
    for t in range(zr.shape[-1]):
        cr, ci = torch.cos(phase), torch.sin(phase)
        vr[..., t] = zr[..., t] * cr + zi[..., t] * ci
        err = torch.atan2(zi[..., t] * cr - zr[..., t] * ci, vr[..., t])
        freq = (freq + ki * err).clamp(-max_freq, max_freq)
        phase = torch.remainder(phase + freq + kp * err, two_pi)
    return vr, phase, freq


_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def sam_exact(zr, zi, phase, freq, bw_hz: float = 100.0, sample_rate: float = 44117.64706):
    """The exact PLL over a segment, before the DC blocker:

      zr, zi:      (C, n) f32 band-passed IQ, any n >= 1
      phase, freq: (C,) f32 carries

    Returns (vr (C, n), phase', freq'). CPU tensors run the plain version;
    CUDA tensors launch ``csrc/sam.cu``'s ``sam_exact``, or raise.
    """
    global LAUNCHES
    if zr.device.type == "cpu":
        return sam_exact_plain(zr, zi, phase, freq, bw_hz, sample_rate)
    if zr.device.type != "cuda":
        raise ValueError(f"the exact SAM PLL runs on cuda or cpu, not {zr.device}")
    _check_sam(zr, zi, phase, freq)
    c, n = zr.shape
    check_launch("sam_exact", (zr, zi))
    if not (phase.is_contiguous() and freq.is_contiguous()):
        raise ValueError("sam_exact takes contiguous phase and freq carries")
    outs = (torch.empty_like(zr), torch.empty_like(phase), torch.empty_like(freq))
    fn = build.load_library("sam").sam_exact
    fn.argtypes = [_PTR] * 7 + [_I32] * 2 + [_F32] * 3 + [_I32, _PTR]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(zr.device).cuda_stream
    with span("rdsp.launch", kernel="sam_exact"):
        err = fn(*(t.data_ptr() for t in (zr, zi, phase, freq) + outs), c, n,
                 *sam.pll_gains(bw_hz, sample_rate), zr.device.index or 0, stream)
    if err:
        raise RuntimeError(f"sam_exact launch failed: cudaError {err}")
    LAUNCHES += 1
    return outs


def _demod_sam(pll, zr, zi, state: SAMStatePlanar, bw_hz, sample_rate):
    _check_sam(zr, zi, *state)
    vr, phase, freq = pll(zr, zi, state.phase, state.freq, bw_hz, sample_rate)
    audio, dc = dc_blocker(vr, state.dc)
    return audio, SAMStatePlanar(phase=phase, freq=freq, dc=dc)


def demod_sam_planar_plain(zr, zi, state: SAMStatePlanar, bw_hz: float = 100.0,
                           sample_rate: float = 44117.64706):
    """Plain PyTorch version of ``demod_sam_planar``."""
    return _demod_sam(sam_exact_plain, zr, zi, state, bw_hz, sample_rate)


def demod_sam_planar(zr, zi, state: SAMStatePlanar, bw_hz: float = 100.0,
                     sample_rate: float = 44117.64706):
    """Synchronous AM of band-passed IQ, the second-order carrier PLL
    (``ops/planar.py:154-186`` of the JAX package), its in-phase product
    through the DC blocker:

      zr, zi: (C, n) f32, any n >= 1
      state:  phase, freq (C,) f32; dc (C, 2) f32

    Returns (audio (C, n), state'). The PLL is ``sam_exact``: CPU tensors
    run its plain version; CUDA tensors launch its kernel, or raise. The DC
    blocker is ``ops/iir.dc_blocker``.
    """
    return _demod_sam(sam_exact, zr, zi, state, bw_hz, sample_rate)


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


def spectral_subtract_planar(l, r, nr_level, nfloor0, dft_cos, dft_sin, tail_l, tail_r,
                             split_dft: bool = True):
    """The backup engine's spectral subtraction on (C, n) stereo planes, the
    DFTs as planar products (z = L + jR per frame, the reference layout).
    ``split_dft=True`` runs both transforms through ``planar_dft_split``
    (dft_cos/dft_sin then give only the size); False multiplies by the
    direct n x n matrices. The floor is tracked across frames, clamped at 0.
    Returns (L', R', nfloor_last, new_tail_l, new_tail_r)."""
    block = dft_cos.shape[0] // 2
    sr, si = _forward_dft(_frames(l, tail_l), _frames(r, tail_r), dft_cos, dft_sin, split_dft)
    mag = torch.sqrt(sr * sr + si * si)

    floor_est = mag[..., VAD_START_BIN:VAD_END_BIN + 1].sum(-1) / (VAD_END_BIN - VAD_START_BIN)
    floor_est = floor_est * float(np.float32(nr_level) * np.float32(1.5))
    nfloor = floor_track(floor_est, nfloor0).clamp(min=0.0)

    nf = nfloor[..., None]
    scale = torch.where(mag <= nf, UNDER_FLOOR_GAIN, 1.0 - nf / mag.clamp(min=1e-20))
    # the subtracted magnitude with the original phase == the scaled bin
    yl, yr = _inverse_dft(sr * scale, si * scale, dft_cos, dft_sin, split_dft)
    out_l = yl[..., block:].reshape(l.shape)
    out_r = yr[..., block:].reshape(r.shape)
    return (out_l, out_r, nfloor[..., -1].contiguous(), l[:, -block:].contiguous(),
            r[:, -block:].contiguous())


def _forward_dft(fl, fr_, dft_cos, dft_sin, split_dft):
    """The DFT of the frames z = fl + j fr_: (re, im)."""
    if split_dft:
        return planar_dft_split(fl, fr_, dft_cos.shape[0])
    return (matmul_fp32(fl, dft_cos) + matmul_fp32(fr_, dft_sin),
            matmul_fp32(fr_, dft_cos) - matmul_fp32(fl, dft_sin))


def _inverse_dft(sr2, si2, dft_cos, dft_sin, split_dft):
    """y = (sr2 + j si2) @ (C + jS) / n = conj(DFT(conj(spec))) / n: (re, im)."""
    n = dft_cos.shape[0]
    if split_dft:
        ar, ai = planar_dft_split(sr2, -si2, n)
        return ar * (1.0 / n), -ai * (1.0 / n)
    return ((matmul_fp32(sr2, dft_cos) - matmul_fp32(si2, dft_sin)) * (1.0 / n),
            (matmul_fp32(si2, dft_cos) + matmul_fp32(sr2, dft_sin)) * (1.0 / n))


def inline_denoise_planar(xr, xi, dft_cos, dft_sin, tail_r, tail_i, split_dft: bool = True):
    """The backup sketch's inline pre-demod spectral denoise
    (``doConvolutionalProcessing_Denoise``, src/backup/RadioDSP_SDR_RX_Conv.ino:
    1520-1650) on (C, n) mixed IQ, per overlap-save frame z = xr + j xi:
    th = (sum of |Z| over bins 60..120) / 60 * 3, |Z| <= th scaled by 0.2,
    else reduced by th, with the phase kept; the right half of the inverse
    DFT out. No FIR mask (commented out in the source, :1633) and no carry
    of the threshold across frames (``loop()`` reseeds it before every call,
    so each frame's threshold is its own band mean). Returns (xr', xi',
    new_tail_r, new_tail_i), the tails the input's last block."""
    n = dft_cos.shape[0]
    block = n // 2
    sr, si = _forward_dft(_frames(xr, tail_r), _frames(xi, tail_i), dft_cos, dft_sin,
                          split_dft)
    mag = torch.sqrt(sr * sr + si * si)
    th = (mag[..., INLINE_START_BIN:INLINE_END_BIN + 1].sum(-1)
          / (INLINE_END_BIN - INLINE_START_BIN)) * INLINE_MULT
    thb = th[..., None]
    scale = torch.where(mag <= thb, UNDER_FLOOR_GAIN, 1.0 - thb / mag.clamp(min=1e-20))
    yl, yr = _inverse_dft(sr * scale, si * scale, dft_cos, dft_sin, split_dft)
    return (yl[..., block:].reshape(xr.shape), yr[..., block:].reshape(xi.shape),
            xr[:, -block:], xi[:, -block:])
