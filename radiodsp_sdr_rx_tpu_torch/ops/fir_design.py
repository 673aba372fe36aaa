"""Complex windowed-sinc FIR design and the collapsed overlap-save operators.

A numpy copy of ``radiodsp_sdr_rx_tpu/ops/fir_design.py``. Coefficients are
designed in float64 on the host, as the reference's ``calc_cplx_FIR_coeffs``
(RDSP_convolutional.h:127-185) does; the mask is the reference's
``init_filter_mask`` (:87-110). The per-block chain
``FFT -> mask multiply -> iFFT -> keep right half`` (:291-318) is a linear map
of the 256-sample frame, precomputed once here as a matrix so that the whole
overlap-save filter is one matrix product on the card.
"""

from __future__ import annotations

import numpy as np

from radiodsp_sdr_rx_tpu_torch.ops.windows import fir_window

DEFAULT_FFT_LENGTH = 256


def calc_cplx_fir_coeffs(num_taps: int, f_lo_cut: float, f_hi_cut: float,
                         sample_rate: float, window_id: int = 1) -> np.ndarray:
    """Complex band-pass FIR coefficients h[i] = I[i] + j*Q[i] (complex128).

    A windowed-sinc low-pass of cutoff (fHi-fLo)/2 shifted by (fHi+fLo)/2.
    The singular centre tap is left unwindowed (z = 2*nFc), as in the
    reference (RDSP_convolutional.h:149-150).
    """
    n_fl = f_lo_cut / sample_rate
    n_fh = f_hi_cut / sample_rate
    n_fc = (n_fh - n_fl) / 2.0
    n_fs = np.pi * (n_fh + n_fl)
    f_center = 0.5 * (num_taps - 1)

    x = np.arange(num_taps, dtype=np.float64) - f_center
    win = fir_window(window_id, num_taps)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.sin(2.0 * np.pi * x * n_fc) / (np.pi * x) * win
    z = np.where(np.abs(x) < 0.01, 2.0 * n_fc, z)
    return (z * np.cos(n_fs * x) + 1j * z * np.sin(n_fs * x)).astype(np.complex128)


def filter_mask_from_coeffs(coeffs: np.ndarray,
                            fft_length: int = DEFAULT_FFT_LENGTH,
                            replicate_reference_tail_quirk: bool = True
                            ) -> np.ndarray:
    """H = FFT(h zero-padded to fft_length). The reference's zero-fill loop
    clears the imaginary part of the last tap (RDSP_convolutional.h:102-105);
    that quirk is kept by default for parity."""
    h = np.zeros(fft_length, dtype=np.complex128)
    n = len(coeffs)
    h[:n] = coeffs
    if replicate_reference_tail_quirk and 2 * n > fft_length + 1:
        h[n - 1] = h[n - 1].real
    return np.fft.fft(h)


def design_filter_mask(f_lo_cut: float, f_hi_cut: float, sample_rate: float,
                       fft_length: int = DEFAULT_FFT_LENGTH,
                       num_taps: int | None = None,
                       window_id: int = 1) -> np.ndarray:
    """Design the coefficients and return the length-``fft_length`` mask."""
    if num_taps is None:
        num_taps = fft_length // 2 + 1
    coeffs = calc_cplx_fir_coeffs(num_taps, f_lo_cut, f_hi_cut, sample_rate,
                                  window_id)
    return filter_mask_from_coeffs(coeffs, fft_length)


def overlap_save_matrix(mask: np.ndarray) -> np.ndarray:
    """The frame map ``y = iFFT(mask * FFT(x))[half:]`` as a (half, fft_length)
    complex matrix: A[m, n] = h[(m + half - n) mod fft_length], h = iFFT(mask)."""
    fft_length = len(mask)
    half = fft_length // 2
    h = np.fft.ifft(mask)
    m = np.arange(half)[:, None] + half
    n = np.arange(fft_length)[None, :]
    return h[(m - n) % fft_length].astype(np.complex128)


def overlap_save_matrix_real(mask: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Real-stacked (2*fft_length, fft_length) form of overlap_save_matrix:
    frames ``[Re | Im] @ W == [Re | Im]`` of the filtered right half."""
    a = overlap_save_matrix(mask)
    ar, ai = a.real, a.imag
    top = np.concatenate([ar.T, ai.T], axis=1)
    bot = np.concatenate([-ai.T, ar.T], axis=1)
    return np.concatenate([top, bot], axis=0).astype(dtype)
