"""Decimating filters and the digital down-converter (``radiodsp_sdr_rx_tpu/ops/decimate.py``).

A decimate-by-M FIR is the overlap-save filter keeping every M-th output: a
row slice of the collapsed operator (``fir_design.overlap_save_matrix``),
``A_dec = A[::M]`` of shape (F/2/M, F), so the whole decimating filter is one
product whose discarded outputs are never computed (the polyphase identity
at the operator level). ``ddc_planar`` chains the DDS mixer with the sliced
operator; the anti-alias low-pass is the windowed-sinc design of the rest
of the receiver (complex band +-bw/2). The product runs in full fp32
(``chain_common.matmul_fp32``), the JAX ``Precision.HIGHEST``; the mix is
``chain_common.mix``, the DDS phase read as int32 as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.ops import nco
from radiodsp_sdr_rx_tpu_torch.ops.chain_common import matmul_fp32, mix
from radiodsp_sdr_rx_tpu_torch.ops.fir_design import design_filter_mask, overlap_save_matrix
from radiodsp_sdr_rx_tpu_torch.ops.planar import frame_planar


def decimating_operator(mask: np.ndarray, factor: int) -> np.ndarray:
    """Real-stacked decimating overlap-save operator W (2F, 2 F/2/M): with
    frames X = [Re | Im] (nb, 2F), Y = X @ W is [Re | Im] of the
    M-decimated filtered block (F/2/M complex outputs per F/2 inputs)."""
    fft_length = len(mask)
    half = fft_length // 2
    if half % factor:
        raise ValueError(f"block {half} not divisible by factor {factor}")
    a = overlap_save_matrix(mask)[::factor]          # (half/M, F) complex
    ar, ai = a.real, a.imag
    top = np.concatenate([ar.T, ai.T], axis=1)       # (F, 2*half/M)
    bot = np.concatenate([-ai.T, ar.T], axis=1)
    return np.concatenate([top, bot], axis=0).astype(np.float32)


def design_decimator(factor: int, sample_rate: float, fft_length: int = 256,
                     cutoff_scale: float = 0.8, window_id: int = 1) -> np.ndarray:
    """Anti-alias low-pass operator for decimate-by-``factor``: passband
    +-(fs/2M)*cutoff_scale, complex symmetric."""
    bw = sample_rate / (2.0 * factor) * cutoff_scale
    mask = design_filter_mask(-bw, bw, sample_rate, fft_length, window_id=window_id)
    return decimating_operator(mask, factor)


def decimating_filter_planar(xr, xi, w_dec: torch.Tensor, tail_r, tail_i):
    """Filter and decimate a planar stream with the sliced operator.

    xr, xi: (..., n); w_dec: (2F, 2 F/2/M) on their device; tails: (...,
    F/2). Returns (yr, yi, new_tail_r, new_tail_i), outputs of length n/M.
    """
    block = w_dec.shape[0] // 4
    out_half = w_dec.shape[1] // 2
    x2 = torch.cat([frame_planar(xr, tail_r, block), frame_planar(xi, tail_i, block)], dim=-1)
    y = matmul_fp32(x2, w_dec)                       # (..., nb, 2*out_half)
    yr = y[..., :out_half].reshape(*xr.shape[:-1], -1)
    yi = y[..., out_half:].reshape(*xr.shape[:-1], -1)
    return yr, yi, xr[..., -block:], xi[..., -block:]


def ddc_planar(xr, xi, phase0, phase_inc, w_dec: torch.Tensor, tail_r, tail_i):
    """Digital down-converter: DDS mix to baseband, then the decimating
    low-pass. ``phase0`` and ``phase_inc`` are DDS words, int64 in [0, 2^32)
    (tensors broadcastable to the leading axes, or Python ints). Returns
    (yr, yi, next_phase, new_tail_r, new_tail_i), the output at the input
    rate / M. The tails carry the mixed stream, so segments stay exact."""
    n = xr.shape[-1]
    lead = xr.shape[:-1]
    ph = torch.as_tensor(phase0, dtype=torch.int64, device=xr.device).expand(lead)
    inc = torch.as_tensor(phase_inc, dtype=torch.int64, device=xr.device).expand(lead)
    pos = torch.arange(n, dtype=torch.int64, device=xr.device)
    mr, mi = mix(xr.reshape(-1, n), xi.reshape(-1, n), ph.reshape(-1), inc.reshape(-1), pos)
    yr, yi, tr, ti = decimating_filter_planar(mr.reshape(xr.shape), mi.reshape(xi.shape),
                                              w_dec, tail_r, tail_i)
    return yr, yi, nco.advance_phase(ph, n, inc), tr, ti
