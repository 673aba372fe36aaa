"""Spectral-subtraction noise reduction (``radiodsp_sdr_rx_tpu/ops/spectral_sub.py``).

The reference's experimental engine (src/backup/RDSP_convolutional_spec.h:
109-252), per 256-point overlap-save frame:

    mag       = |FFT(frame)|
    floor_est = mean(mag[30:181]) * (level * 1.5)   (the 151-bin sum divided
                by 150, the reference's own off-by-one, replicated)
    nfloor   += (floor_est - nfloor) * 0.65         (one pole across frames)
    mag'      = where(mag <= nfloor, mag * 0.2, mag - nfloor)
    out       = iFFT(mag' * exp(j*angle(FFT(frame))))[128:]

``spectral_matmul_ops`` gives the two operators the K4 kernel
(``ops/sweep_spec.py``) multiplies by, numpy built in float64 and emitted
f32, bit-equal to the JAX package's. ``spectral_subtract_frames`` is the
complex cross-check on ``torch.fft``; the chain itself runs the planar
form, ``ops/planar.spectral_subtract_planar``.
"""

from __future__ import annotations

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.ops.chain_common import iir_rows

VAD_START_BIN = 30   # STATING_BIN_VAD_ANALISYS (RDSP_convolutional_spec.h:34)
VAD_END_BIN = 180    # ENDING_BIN_VAD_ANALISYS (RDSP_convolutional_spec.h:35)
FLOOR_BETA = 0.65    # one-pole floor tracking (RDSP_convolutional_spec.h:114)
UNDER_FLOOR_GAIN = 0.2  # below-floor attenuation (RDSP_convolutional_spec.h:214)

# the backup sketch's INLINE pre-demod denoise threshold law
# (src/backup/RadioDSP_SDR_RX_Conv.ino:1591-1597): mean of magnitude bins
# 60..120 inclusive (61 bins summed, divided by 60) times 3, applied with the
# same 0.2 under-floor gain; its stage comes with ROADMAP item 7
INLINE_START_BIN = 60
INLINE_END_BIN = 120
INLINE_MULT = 3.0
INLINE_SEED = 0.8    # loop() reseed when the menu enables denoise (:1347)


def spectral_matmul_ops(n: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """The planar DFT and the right-half inverse DFT as two operators:

        [fl | fr] (., 2n) @ W_fwd (2n, 2n) = [sr | si]
            sr = fl@C + fr@S, si = fr@C - fl@S  (z = L + jR)
        [sr' | si'] (., 2n) @ W_inv (2n, n) = [yl_right | yr_right]
            yl = (sr'@C - si'@S)/n, yr = (si'@C + sr'@S)/n, columns n/2..n

    Built in float64, returned f32."""
    k = np.arange(n)
    w = 2.0 * np.pi * np.outer(k, k) / n
    c = np.cos(w)
    s = np.sin(w)
    w_fwd = np.block([[c, -s], [s, c]]).astype(np.float32)
    cr = c[:, n // 2:] / n
    sr_ = s[:, n // 2:] / n
    w_inv = np.block([[cr, sr_], [-sr_, cr]]).astype(np.float32)
    return w_fwd, w_inv


def floor_track(floor_est: torch.Tensor, nfloor0: torch.Tensor) -> torch.Tensor:
    """nf[k] = (1 - beta) * nf[k-1] + beta * floor_est[k] along the last
    (frame) axis of (..., frames), nf[-1] = nfloor0 (...,): the JAX
    package's associative scan, run as a doubling scan. Unclamped."""
    a = 1.0 - FLOOR_BETA
    bv = FLOOR_BETA * floor_est
    bv = torch.cat([bv[..., :1] + a * nfloor0[..., None], bv[..., 1:]], dim=-1)
    return iir_rows(bv, a)


def spectral_subtract_frames(frames: torch.Tensor, nr_level, nfloor0: torch.Tensor):
    """Spectral subtraction of complex overlap-save frames (..., nb,
    fft_length) with the floor carry nfloor0 (...,). Returns (the filtered
    right halves (..., nb, fft_length/2) complex, the last frame's floor,
    clamped at 0)."""
    fft_length = frames.shape[-1]
    spec = torch.fft.fft(frames, dim=-1)
    mag = spec.abs()
    band = mag[..., VAD_START_BIN:VAD_END_BIN + 1]
    floor_est = band.sum(-1) / (VAD_END_BIN - VAD_START_BIN)
    floor_est = floor_est * float(np.float32(nr_level) * np.float32(1.5))
    nfloor = floor_track(floor_est, nfloor0).clamp(min=0.0)
    nf = nfloor[..., None]
    mag_sub = torch.where(mag <= nf, mag * UNDER_FLOOR_GAIN, mag - nf)
    phase = torch.angle(spec)
    new_spec = torch.complex(mag_sub * torch.cos(phase), mag_sub * torch.sin(phase))
    out = torch.fft.ifft(new_spec, dim=-1)[..., fft_length // 2:]
    return out, nfloor[..., -1]
