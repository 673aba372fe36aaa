"""Spectrum analyzers (``radiodsp_sdr_rx_tpu/ops/analyzers.py``).

The 256-point IQ panadapter, the reference's ``AudioAnalyzeFFT256IQ``
(analyze_fft256iq.cpp): frames of 256 at stride 128, each [previous block |
current block], a periodic Hann window, a complex FFT scaled by 1/256, |.|^2
averaged over ``naverage`` frames, sqrt, x32768 (q15 units), and the
centre-DC reorder ``output[255 - (i ^ 128)] = bin[i]``. The 1024-point audio
scope, Teensy's ``AudioAnalyzeFFT1024`` (RadioDSP_SDR_RX.ino:147-148): the
same framing at stride 512 of a real stream, bins 0..511 of the FFT.
``spectrum_read`` is the analyzers' read() normalisation. The sharded
panadapter (``parallel/stream_shard.sharded_panadapter``) runs
``iq_spectrum_frames`` on every time shard.

The default windows and the bin order are copied to a device once and kept
(``_on_device``), so that a call on a card copies nothing from the host and
waits for nothing (``models/metrics.analyze`` runs under
``torch.cuda.set_sync_debug_mode("error")`` in chip_smoke.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.ops.windows import hann_periodic


def iq_panadapter_bin_order(n: int = 256) -> np.ndarray:
    """Gather indices g with displayed[j] = fftbin[g[j]] (analyze_fft256iq.cpp:107)."""
    j = np.arange(n)
    return (n - 1 - j) ^ (n // 2)


@functools.lru_cache(maxsize=None)
def _on_device(kind: str, n: int, device: torch.device) -> torch.Tensor:
    """The f32 periodic Hann window ("hann") or the panadapter's int64 bin
    order ("order") of length n on ``device``, copied there once."""
    host = (hann_periodic(n).astype(np.float32) if kind == "hann"
            else iq_panadapter_bin_order(n).astype(np.int64))
    return torch.from_numpy(host).to(device)


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


def _grouped_mean(magsq: torch.Tensor, naverage: int) -> torch.Tensor:
    """Mean over groups of ``naverage`` consecutive frames (a partial last
    group dropped): (..., frames, bins) -> (..., frames // naverage, bins)."""
    ng = magsq.shape[-2] // naverage
    bins = magsq.shape[-1]
    return magsq[..., :ng * naverage, :].reshape(
        *magsq.shape[:-2], ng, naverage, bins).mean(dim=-2)


def iq_spectrum_frames(iq: torch.Tensor, naverage: int = 30, window=None,
                       tail: torch.Tensor | None = None) -> torch.Tensor:
    """Panadapter spectra of a complex64 stream (..., n), n a multiple of 128:
    (..., n_updates, 256) f32 in display order and q15 units, one row per
    ``naverage`` frames."""
    fft_len = 256
    if window is None:
        window = _on_device("hann", fft_len, iq.device)
    frames = _frames_50pct(iq, fft_len, tail) * window
    magsq = (torch.fft.fft(frames, dim=-1) / fft_len).abs() ** 2
    mag = torch.sqrt(_grouped_mean(magsq, naverage)) * 32768.0
    return mag[..., _on_device("order", fft_len, iq.device)]


def audio_spectrum_frames(audio: torch.Tensor, naverage: int = 30, window=None,
                          tail: torch.Tensor | None = None) -> torch.Tensor:
    """1024-point audio scope spectra of a real f32 stream (..., n), n a
    multiple of 512: (..., n_updates, 512) f32, the positive-frequency
    magnitudes (bins 0..511) in q15 units, averaged over ``naverage`` frames."""
    fft_len = 1024
    if window is None:
        window = _on_device("hann", fft_len, audio.device)
    frames = _frames_50pct(audio, fft_len, tail) * window
    spec = torch.fft.rfft(frames, dim=-1)[..., :fft_len // 2] / fft_len
    return torch.sqrt(_grouped_mean(spec.abs() ** 2, naverage)) * 32768.0


def spectrum_read(output: torch.Tensor) -> torch.Tensor:
    """The analyzers' read() normalisation (analyze_fft256iq.h:69-72)."""
    return output / 16384.0
