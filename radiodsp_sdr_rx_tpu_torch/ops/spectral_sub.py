"""Spectral-subtraction noise reduction (``radiodsp_sdr_rx_tpu/ops/spectral_sub.py``).

The reference's experimental engine (src/backup/RDSP_convolutional_spec.h:
109-252), per 256-point overlap-save frame:

    mag       = |FFT(frame)|
    floor_est = mean(mag[30:181]) * (level * 1.5)   (the 151-bin sum divided
                by 150, the reference's own off-by-one, replicated)
    nfloor   += (floor_est - nfloor) * 0.65         (one pole across frames)
    mag'      = where(mag <= nfloor, mag * 0.2, mag - nfloor)
    out       = iFFT(mag' * exp(j*angle(FFT(frame))))[128:]

``spectral_matmul_ops`` gives the two operators the TPU's K4 kernel
multiplies by, numpy built in float64 and emitted f32, bit-equal to the JAX
package's; the port's plain spectral stage (``ops/sweep.spectral_plain``)
multiplies by them too. The port's kernels compute the same DFT as a
256-point FFT inside the block (``csrc/sweep_chain.cuh``, namespace fft):
``fft_twiddles`` is their twiddle table, ``fft256_model`` and
``spectral_fft_model`` that FFT and that stage in PyTorch, stage for stage,
for the tests (nothing on the main path runs them). ``spectral_subtract_frames``
is the complex cross-check on ``torch.fft``; the chain itself runs the planar
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


FFT_N = 256


def fft_twiddles(dtype=np.float32) -> np.ndarray:
    """The spectral kernels' FFT twiddles W^j = exp(-2 pi i j / 256), j =
    0..255, as (2, 256) [cos | -sin]: built in float64, rounded to dtype."""
    w = 2.0 * np.pi * np.arange(FFT_N) / FFT_N
    return np.stack([np.cos(w), -np.sin(w)]).astype(dtype)


def fft_bin_of(p):
    """The natural bin k1 + 8 k2a + 64 k2b at digit-reversed position p =
    32 k1 + 4 k2a + k2b, where the kernels' forward FFT (radix 8, 8, 4 by
    decimation in frequency) leaves it: lane q's register j is p = 8q + j."""
    p = np.asarray(p)
    return (p >> 5) + 8 * ((p >> 2) & 7) + 64 * (p & 3)


def _cmul(xr, xi, wr, wi, inverse):
    if inverse:
        wi = -wi
    return xr * wr - xi * wi, xr * wi + xi * wr


def _dft8(xr, xi, c, inverse):
    """fft::dft8 along the second-to-last axis (8): radix 2 by decimation in
    frequency, natural order in and out; c = sqrt(1/2), W^32's real part."""
    xr, xi = list(xr.unbind(-2)), list(xi.unbind(-2))
    for m in range(4):
        ar, ai, br, bi = xr[m], xi[m], xr[m + 4], xi[m + 4]
        xr[m], xi[m] = ar + br, ai + bi
        dr, di = ar - br, ai - bi
        if m == 0:
            xr[4], xi[4] = dr, di
        elif m == 1:
            xr[5], xi[5] = (c * (dr - di), c * (dr + di)) if inverse else \
                (c * (dr + di), c * (di - dr))
        elif m == 2:
            xr[6], xi[6] = (-di, dr) if inverse else (di, -dr)
        else:
            xr[7], xi[7] = (c * -(dr + di), c * (dr - di)) if inverse else \
                (c * (di - dr), c * -(dr + di))
    for h in (0, 4):
        for m in (0, 1):
            ar, ai, br, bi = xr[h + m], xi[h + m], xr[h + m + 2], xi[h + m + 2]
            xr[h + m], xi[h + m] = ar + br, ai + bi
            dr, di = ar - br, ai - bi
            xr[h + m + 2], xi[h + m + 2] = (dr, di) if m == 0 else \
                ((-di, dr) if inverse else (di, -dr))
    for p in (0, 2, 4, 6):
        ar, ai, br, bi = xr[p], xi[p], xr[p + 1], xi[p + 1]
        xr[p], xi[p], xr[p + 1], xi[p + 1] = ar + br, ai + bi, ar - br, ai - bi
    order = (0, 4, 2, 6, 1, 5, 3, 7)   # position p holds bin bitrev(p)
    return (torch.stack([xr[k] for k in order], -2), torch.stack([xi[k] for k in order], -2))


def _dft4(xr, xi, inverse):
    """fft::dft4 along the last axis (4), W4 = -+i."""
    x0, x1, x2, x3 = xr.unbind(-1)
    y0, y1, y2, y3 = xi.unbind(-1)
    t0r, t0i, t1r, t1i = x0 + x2, y0 + y2, x0 - x2, y0 - y2
    t2r, t2i, dr, di = x1 + x3, y1 + y3, x1 - x3, y1 - y3
    t3r, t3i = (-di, dr) if inverse else (di, -dr)
    return (torch.stack([t0r + t2r, t1r + t3r, t0r - t2r, t1r - t3r], -1),
            torch.stack([t0i + t2i, t1i + t3i, t0i - t2i, t1i - t3i], -1))


def fft256_model(zr, zi, tw, inverse=False):
    """The kernels' FFT (fft::forward, or fft::inverse) along the last axis
    (256) of zr + i zi, in their dtype, with the twiddle table tw (2, 256)
    (``fft_twiddles`` as a tensor of that dtype): the same radices, stage
    order and twiddles. forward takes time in natural order and returns the
    bins in digit-reversed order (position p holds bin ``fft_bin_of(p)``);
    inverse takes that order and returns y[n] in natural order, unscaled
    (256 times the inverse DFT)."""
    twr, twi = tw[0], tw[1]
    c = twr[FFT_N // 8]
    k = torch.arange(8, device=zr.device)
    w1 = k[:, None] * torch.arange(32, device=zr.device)   # (k1, l): l k1
    w2 = 8 * k[:, None] * torch.arange(4, device=zr.device)   # (k2a, l1): 8 l1 k2a
    sh = zr.shape[:-1]
    if not inverse:
        xr, xi = _dft8(zr.reshape(*sh, 8, 32), zi.reshape(*sh, 8, 32), c, False)   # (m, l) -> (k1, l)
        xr, xi = _cmul(xr, xi, twr[w1], twi[w1], False)
        xr, xi = _dft8(xr.reshape(*sh, 8, 8, 4), xi.reshape(*sh, 8, 8, 4), c, False)  # l2 -> k2a
        xr, xi = _cmul(xr, xi, twr[w2], twi[w2], False)
        xr, xi = _dft4(xr, xi, False)                                           # l1 -> k2b
        return xr.reshape(*sh, FFT_N), xi.reshape(*sh, FFT_N)
    xr, xi = _dft4(zr.reshape(*sh, 8, 8, 4), zi.reshape(*sh, 8, 8, 4), True)   # k2b -> l1
    xr, xi = _cmul(xr, xi, twr[w2], twi[w2], True)
    xr, xi = _dft8(xr, xi, c, True)                                             # k2a -> l2
    xr, xi = _cmul(xr.reshape(*sh, 8, 32), xi.reshape(*sh, 8, 32), twr[w1], twi[w1], True)
    xr, xi = _dft8(xr, xi, c, True)                                             # k1 -> m
    return xr.reshape(*sh, FFT_N), xi.reshape(*sh, FFT_N)


def spectral_fft_model(l, r, nfloor0, tail_l, tail_r, nr_gain):
    """The kernels' spectral stage (``spectral_rows``) on the post-PBT l, r
    (C, n) in their dtype: each 128-sample row's frame [prev_l | l] + i
    [prev_r | r] through ``fft256_model``, the VAD sum over the positions
    whose bin lies in the band, the floor as the sequential one-pole
    recurrence from the carry nfloor0 (C,), scale, inverse, the right halves
    times 1/256. nr_gain is ``ops/sweep.nr_gain``'s. Returns (yl, yr (C, n),
    the floor per row (C, rows), unclamped)."""
    c, n = l.shape
    l3, r3 = l.view(c, n // 128, 128), r.view(c, n // 128, 128)
    fr = torch.cat([torch.cat([tail_l[:, None], l3[:, :-1]], 1), l3], -1)
    fi = torch.cat([torch.cat([tail_r[:, None], r3[:, :-1]], 1), r3], -1)
    tw = torch.as_tensor(fft_twiddles(np.float32 if l.dtype == torch.float32 else np.float64),
                         device=l.device)
    sr, si = fft256_model(fr, fi, tw)
    mag = torch.sqrt(sr * sr + si * si)
    bins = fft_bin_of(np.arange(FFT_N))
    fsum = mag[..., torch.as_tensor((bins >= VAD_START_BIN) & (bins <= VAD_END_BIN))].sum(-1)
    nf, floors = nfloor0, []
    for j in range(n // 128):
        nf = FLOOR_BETA * (fsum[:, j] * nr_gain) + (1.0 - FLOOR_BETA) * nf
        floors.append(nf)
    nfloor = torch.stack(floors, -1)
    nfc = nfloor.clamp(min=0.0)[..., None]
    scale = torch.where(mag <= nfc, UNDER_FLOOR_GAIN, 1.0 - nfc / mag.clamp(min=1e-20))
    yr, yi = fft256_model(sr * scale, si * scale, tw, inverse=True)
    return (yr[..., 128:].reshape(c, n) / FFT_N, yi[..., 128:].reshape(c, n) / FFT_N, nfloor)
