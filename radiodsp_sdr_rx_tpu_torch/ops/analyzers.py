"""The 256-point IQ panadapter (``radiodsp_sdr_rx_tpu/ops/analyzers.py:36-90``).

The reference's ``AudioAnalyzeFFT256IQ`` (analyze_fft256iq.cpp): frames of
256 at stride 128, each [previous block | current block], a periodic Hann
window, a complex FFT scaled by 1/256, |.|^2 averaged over ``naverage``
frames, sqrt, x32768 (q15 units), and the centre-DC reorder
``output[255 - (i ^ 128)] = bin[i]``. The sharded panadapter
(``parallel/stream_shard.sharded_panadapter``) runs it on every time shard.
The audio analyzer and the rest of the JAX module come with the scopes.
"""

from __future__ import annotations

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.ops.windows import hann_periodic


def iq_panadapter_bin_order(n: int = 256) -> np.ndarray:
    """Gather indices g with displayed[j] = fftbin[g[j]] (analyze_fft256iq.cpp:107)."""
    j = np.arange(n)
    return (n - 1 - j) ^ (n // 2)


def _frames_50pct(x: torch.Tensor, frame: int, tail: torch.Tensor | None = None):
    """Frames of ``frame`` samples at stride frame/2 over the last axis. With
    ``tail`` (the previous segment's last half-frame) frame b is [block b-1 |
    block b], one frame per block; without it, nb-1 frames within the segment."""
    block = frame // 2
    nb = x.shape[-1] // block
    blocks = x[..., :nb * block].reshape(*x.shape[:-1], nb, block)
    if tail is not None:
        prev = torch.cat([tail[..., None, :], blocks[..., :-1, :]], dim=-2)
        return torch.cat([prev, blocks], dim=-1)
    return torch.cat([blocks[..., :-1, :], blocks[..., 1:, :]], dim=-1)


def iq_spectrum_frames(iq: torch.Tensor, naverage: int = 30, window=None,
                       tail: torch.Tensor | None = None) -> torch.Tensor:
    """Panadapter spectra of a complex64 stream (..., n), n a multiple of 128:
    (..., n_updates, 256) f32 in display order and q15 units, one row per
    ``naverage`` frames."""
    fft_len = 256
    if window is None:
        window = torch.as_tensor(hann_periodic(fft_len), dtype=torch.float32,
                                 device=iq.device)
    frames = _frames_50pct(iq, fft_len, tail) * window
    magsq = (torch.fft.fft(frames, dim=-1) / fft_len).abs() ** 2
    ng = magsq.shape[-2] // naverage
    grouped = magsq[..., :ng * naverage, :].reshape(*magsq.shape[:-2], ng, naverage, fft_len)
    mag = torch.sqrt(grouped.mean(dim=-2)) * 32768.0
    order = torch.as_tensor(iq_panadapter_bin_order(fft_len), device=iq.device)
    return mag[..., order]
