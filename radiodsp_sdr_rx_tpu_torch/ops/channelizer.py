"""Polyphase filter-bank (PFB) channelizers (``radiodsp_sdr_rx_tpu/ops/channelizer.py``).

Split a wideband IQ stream into M equally spaced channels in one pass: the
polyphase sums of the stream against the prototype low-pass (P
slice-multiply-adds over a reshape of the stream, no gather), then an
M-point DFT across the phases as a cos/sin product pair. Channel k is
centred at k*fs/M (wrapping above fs/2 to negative frequencies).
``PFBChannelizer`` is critically sampled (rate fs/M); ``OversampledPFB``
hops M/2 (rate 2*fs/M), so a signal anywhere inside a channel survives for
a downstream re-mix (the SSB bank of ``models/channelized.py``).

The DFT products are ``Precision.HIGHEST`` in JAX, XLA outside any Pallas
kernel; here they are ``chain_common.matmul_fp32`` (TF32 off around the
product). Each channelizer keeps its constants on its device
(``device=None``: the card); the inputs and state must be there.
"""

from __future__ import annotations

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.ops.chain_common import matmul_fp32
from radiodsp_sdr_rx_tpu_torch.ops.fir_design import calc_cplx_fir_coeffs
from radiodsp_sdr_rx_tpu_torch.ops.planar import dft_matrices
from radiodsp_sdr_rx_tpu_torch.utils.convert import resolve_device


def design_prototype(n_channels: int, taps_per_phase: int = 8,
                     sample_rate: float = 44117.64706,
                     cutoff_scale: float = 1.0, window_id: int = 1) -> np.ndarray:
    """Real prototype low-pass of length M*P, cutoff fs/(2M)*scale, unity DC gain."""
    m, p = n_channels, taps_per_phase
    bw = sample_rate / (2.0 * m) * cutoff_scale
    h = calc_cplx_fir_coeffs(m * p, -bw, bw, sample_rate, window_id).real
    return (h / h.sum()).astype(np.float32)


class _PFB:
    """What both channelizers share: the prototype as (P, M) phases (row j
    the taps h[j*M + r]), the M-point DFT matrices, both as numpy and on the
    device, and the DFT across phases of the polyphase sums."""

    def __init__(self, n_channels: int, taps_per_phase: int, sample_rate: float, device):
        self.m = n_channels
        self.p = taps_per_phase
        self.device = resolve_device(device)
        proto = design_prototype(n_channels, taps_per_phase, sample_rate)
        self.h_poly = proto.reshape(taps_per_phase, n_channels)   # (P, M)
        self.dft_cos, self.dft_sin = dft_matrices(n_channels)
        self._h = torch.from_numpy(self.h_poly).to(self.device)
        self._cos = torch.from_numpy(self.dft_cos).to(self.device)
        self._sin = torch.from_numpy(self.dft_sin).to(self.device)

    def init_state(self, leading: tuple = ()) -> torch.Tensor:
        """(..., 2 hist) f32 zeros, the planar history carry [re | im]."""
        return torch.zeros(leading + (2 * self.hist,), device=self.device)

    def _dft(self, vr, vi):
        """(vr + j vi)(C - jS) of (..., frames, M) -> (..., M, frames) planes."""
        yr = matmul_fp32(vr, self._cos) + matmul_fp32(vi, self._sin)
        yi = matmul_fp32(vi, self._cos) - matmul_fp32(vr, self._sin)
        return yr, yi


class PFBChannelizer(_PFB):
    """Critically-sampled polyphase channelizer for planar IQ streams.

    >>> ch = PFBChannelizer(n_channels=64, device="cpu")
    >>> yr, yi, state = ch(xr, xi, state)   # (..., n) -> (..., 64, n//64)
    """

    def __init__(self, n_channels: int, taps_per_phase: int = 8,
                 sample_rate: float = 44117.64706, device=None):
        super().__init__(n_channels, taps_per_phase, sample_rate, device)
        self.hist = (taps_per_phase - 1) * n_channels

    def __call__(self, xr: torch.Tensor, xi: torch.Tensor, state: torch.Tensor):
        """Channelize xr, xi (..., n), n a multiple of M. Returns (yr, yi,
        new_state): (..., M, n/M) baseband streams at fs/M, channel k centred
        at +k*fs/M (k >= M/2 wraps negative)."""
        m, p, hist = self.m, self.p, self.hist
        n_out = xr.shape[-1] // m

        def poly(x, carry):
            # b[t, r] = padded[t*M + r]; P shifted slice-multiply-adds
            b = torch.cat([carry, x], dim=-1).reshape(*x.shape[:-1], n_out + p - 1, m)
            acc = self._h[0] * b[..., 0:n_out, :]
            for j in range(1, p):
                acc = acc + self._h[j] * b[..., j:j + n_out, :]
            return acc                                   # (..., n_out, M)

        yr, yi = self._dft(poly(xr, state[..., :hist]), poly(xi, state[..., hist:]))
        new_state = torch.cat([xr[..., -hist:], xi[..., -hist:]], dim=-1)
        return yr.transpose(-1, -2), yi.transpose(-1, -2), new_state


class OversampledPFB(_PFB):
    """2x-oversampled polyphase channelizer (hop H = M/2).

    The channel centres of ``PFBChannelizer``, each channel at 2*fs/M, so
    that its passband is not folded. Frame t is the M-point DFT of the
    polyphase sums at hop H, times the twiddle (-1)^(k(t+1)): the hop's
    (-1)^(kt) and the history offset's (-1)^k, which together flip the sign
    of odd channels on EVEN frames. The stream is reshaped into H-sample
    rows; the low phases (r < H) read even row offsets, the high ones odd.
    """

    def __init__(self, n_channels: int, taps_per_phase: int = 8,
                 sample_rate: float = 44117.64706, device=None):
        if n_channels % 2:
            raise ValueError("n_channels must be even")
        super().__init__(n_channels, taps_per_phase, sample_rate, device)
        self.h = n_channels // 2
        # frame t reads padded[t*H + j*M + r] for j < P, r < M
        self.hist = taps_per_phase * n_channels - self.h

    def __call__(self, xr: torch.Tensor, xi: torch.Tensor, state: torch.Tensor):
        """Channelize xr, xi (..., n), n a multiple of M. Returns (yr, yi,
        new_state), y (..., M, 2n/M) baseband at 2*fs/M, channel k centred
        at +k*fs/M."""
        m, p, h, hist = self.m, self.p, self.h, self.hist
        n = xr.shape[-1]
        if n % m:
            raise ValueError(f"segment length {n} not a multiple of M={m}")
        n_out = 2 * (n // m)
        hp = self._h

        def poly(x, carry):
            padded = torch.cat([carry, x], dim=-1)            # (..., n + hist)
            b = padded.reshape(*x.shape[:-1], padded.shape[-1] // h, h)
            lo = hp[0, :h] * b[..., 0:n_out, :]
            hi = hp[0, h:] * b[..., 1:1 + n_out, :]
            for j in range(1, p):
                lo = lo + hp[j, :h] * b[..., 2 * j:2 * j + n_out, :]
                hi = hi + hp[j, h:] * b[..., 2 * j + 1:2 * j + 1 + n_out, :]
            return torch.cat([lo, hi], dim=-1)                # (..., n_out, M)

        yr, yi = self._dft(poly(xr, state[..., :hist]), poly(xi, state[..., hist:]))
        t = torch.arange(n_out, device=yr.device)[:, None]
        k = torch.arange(m, device=yr.device)[None, :]
        flip = ((t + 1) & 1) * (k & 1) == 1                   # odd channels, even frames
        yr = torch.where(flip, -yr, yr)
        yi = torch.where(flip, -yi, yi)
        new_state = torch.cat([xr[..., -hist:], xi[..., -hist:]], dim=-1)
        return yr.transpose(-1, -2), yi.transpose(-1, -2), new_state
