"""Overlap-save fast convolution on complex streams (``radiodsp_sdr_rx_tpu/ops/fastconv.py``).

The reference filters 128 new samples at a time: a 256-point FFT, a mask
multiply and an inverse FFT, carrying the previous block
(src/RadioDSP_SDR_RX/RDSP_convolutional.h:228-353). Overlap-save has no
dependency between blocks, so a whole segment is framed at once and
filtered either by ``overlap_save_filter``, one real matrix product with the
collapsed operator of ``ops/fir_design.overlap_save_matrix_real`` (the form
the chains use), or by ``overlap_save_filter_fft``, the reference's own
FFT -> mask -> inverse FFT on ``torch.fft``, the cross-check of the first.
The only carry is the previous segment's last block.
"""

from __future__ import annotations

import torch

from radiodsp_sdr_rx_tpu_torch.ops.chain_common import matmul_fp32


def frame_overlap_save(x: torch.Tensor, tail: torch.Tensor, block: int = 128) -> torch.Tensor:
    """Frames (..., n/block, 2*block) of x (..., n), frame b = [x[b-1] | x[b]]
    with ``tail`` (..., block), the previous segment's last block (zeros at
    a stream start), standing in for block -1."""
    n = x.shape[-1]
    blocks = torch.cat([tail, x], dim=-1).reshape(*x.shape[:-1], n // block + 1, block)
    return torch.cat([blocks[..., :-1, :], blocks[..., 1:, :]], dim=-1)


def overlap_save_filter(x: torch.Tensor, w_real: torch.Tensor, tail: torch.Tensor):
    """Filter a complex stream x (..., n) by the collapsed operator w_real
    (2F, F) of a length-F filter, n a multiple of F/2, in full fp32.
    Returns (y with x's shape, new tail (..., F/2))."""
    block = w_real.shape[1] // 2
    frames = frame_overlap_save(x, tail, block)
    y = matmul_fp32(torch.cat([frames.real, frames.imag], dim=-1), w_real)
    return torch.complex(y[..., :block], y[..., block:]).reshape(x.shape), x[..., -block:]


def overlap_save_filter_fft(x: torch.Tensor, mask: torch.Tensor, tail: torch.Tensor):
    """The reference's math: FFT -> mask multiply -> inverse FFT (1/N) ->
    right half (RDSP_convolutional.h:291-318). mask (F,) complex. Returns
    (y with x's shape, new tail)."""
    block = mask.shape[-1] // 2
    frames = frame_overlap_save(x, tail, block)
    y = torch.fft.ifft(torch.fft.fft(frames, dim=-1) * mask, dim=-1)[..., block:]
    return y.reshape(x.shape), x[..., -block:]
