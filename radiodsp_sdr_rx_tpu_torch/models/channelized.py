"""Channelized monitoring bank: PFB front end + per-channel processing
(``radiodsp_sdr_rx_tpu/models/channelized.py``).

Where ``ReceiverBank`` runs M full-rate DDC chains, this bank channelizes
once with the polyphase filter bank (``ops/channelizer.py``) and processes
every channel at the decimated rate:

  - 'baseband': the raw complex channel streams
  - 'am': envelope demod + DC blocker per channel
  - 'power': smoothed per-channel power (band scanner / activity map)
  - 'ssb': 2x-oversampled PFB + per-channel residual DDS + sideband
    filter / SSB demod at the channel rate (+ optional AGC)

Plain PyTorch on the bank's device (``device=None``: the card), as the JAX
bank is XLA under ``jax.jit``. The residual DDS reads the phase and its
increment as int32 and lets ph + j*inc wrap before the float conversion
(``ops/chain_common.mix``); the carried word is int64 in [0, 2^32), the
port's form of JAX's uint32. With ``buffer_remainder`` the unaligned tail of
a feed waits on the bank's device for the next call.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.ops import agc as agc_ops
from radiodsp_sdr_rx_tpu_torch.ops import nco as nco_ops
from radiodsp_sdr_rx_tpu_torch.ops.chain_common import mix
from radiodsp_sdr_rx_tpu_torch.ops.channelizer import OversampledPFB, PFBChannelizer
from radiodsp_sdr_rx_tpu_torch.ops.fir_design import design_filter_mask
from radiodsp_sdr_rx_tpu_torch.ops.iir import dc_blocker, first_order_iir
from radiodsp_sdr_rx_tpu_torch.ops.operators import ssb_demod_operator
from radiodsp_sdr_rx_tpu_torch.ops.planar import ssb_filter_demod_planar
from radiodsp_sdr_rx_tpu_torch.utils.convert import resolve_device


class ChannelizedState(NamedTuple):
    """Field for field the JAX ``ChannelizedState``; DDS words int64."""

    pfb: torch.Tensor      # PFB history carry
    dc: torch.Tensor       # (M, 2) per-channel DC-blocker carry
    power: torch.Tensor    # (M,) smoothed power carry
    nco: torch.Tensor      # (M,) int64 residual-offset DDS phase (ssb mode)
    tail_r: torch.Tensor   # (M, 128) SSB overlap-save tails (ssb mode)
    tail_i: torch.Tensor
    env: torch.Tensor      # (M,) AGC envelope (ssb mode)


_OUT_KEYS = ("baseband_r", "baseband_i", "power_track")


class ChannelizedBank:
    """M-channel PFB receiver bank.

    >>> bank = ChannelizedBank(n_channels=64, demod="am", device="cpu")
    >>> out, state = bank.process(iq, bank.init_state())  # iq (n,), n % M == 0
    >>> out["audio"].shape                                 # (64, n // 64)

    SSB at arbitrary in-channel offsets (2x-oversampled front end; the
    segment a multiple of 64*M so the channel streams frame into 128-sample
    overlap-save blocks):

    >>> bank = ChannelizedBank(n_channels=64, demod="ssb", offsets_hz=offsets,
    ...                        agc="medium")
    >>> out["audio"].shape                                 # (64, n // 64 * 2)
    """

    def __init__(self, n_channels: int, sample_rate: float = 44117.64706,
                 demod: str = "am", taps_per_phase: int = 8,
                 power_tau_blocks: float = 64.0,
                 offsets_hz=None, sideband: str = "usb",
                 filter_lo_hz: float = 300.0, filter_hi_hz: float = 3000.0,
                 agc: str = "off", buffer_remainder: bool = False, device=None):
        if demod not in ("baseband", "am", "power", "ssb"):
            raise ValueError(demod)
        self.m = n_channels
        self.demod = demod
        self.device = resolve_device(device)
        # buffer_remainder=True: arbitrary segment lengths, the unaligned
        # tail carried to the next call (process_planar)
        self.buffer_remainder = buffer_remainder
        self._pending = None
        self.sample_rate = sample_rate
        if demod == "ssb":
            self.pfb = OversampledPFB(n_channels, taps_per_phase, sample_rate, self.device)
            self.channel_rate = 2.0 * sample_rate / n_channels
        else:
            self.pfb = PFBChannelizer(n_channels, taps_per_phase, sample_rate, self.device)
            self.channel_rate = sample_rate / n_channels
        self._pow_a = float(np.exp(-1.0 / power_tau_blocks))

        if demod == "ssb":
            hi = min(filter_hi_hz, 0.45 * self.channel_rate)
            lo, hi = (filter_lo_hz, hi) if sideband == "usb" else (-hi, -filter_lo_hz)
            mask = design_filter_mask(lo, hi, self.channel_rate)
            self._w_ssb = torch.from_numpy(
                np.ascontiguousarray(ssb_demod_operator(mask))).to(self.device)
            offs = np.zeros(n_channels) if offsets_hz is None else np.asarray(
                offsets_hz, np.float64)
            if offs.shape != (n_channels,):
                raise ValueError("offsets_hz must have shape (n_channels,)")
            self._incs = np.stack([
                nco_ops.freq_to_phase_inc(f, self.channel_rate) for f in offs])
            self._incs_t = torch.from_numpy(self._incs.astype(np.int64)).to(self.device)
            presets = agc_ops.agc_presets(self.channel_rate)
            if agc not in presets:
                raise ValueError(f"agc must be one of {sorted(presets)}")
            self._agc = presets[agc]

    def _fn(self, state: ChannelizedState, xr, xi):
        yr, yi, pfb_state = self.pfb(xr, xi, state.pfb)
        out = {"baseband_r": yr, "baseband_i": yi}
        dc, power = state.dc, state.power
        p_inst = yr * yr + yi * yi                         # (M, n_out)
        p_track, power = first_order_iir(p_inst, self._pow_a, 1.0 - self._pow_a, power)
        out["power"] = power
        out["power_track"] = p_track
        nco, tail_r, tail_i, env = state.nco, state.tail_r, state.tail_i, state.env
        if self.demod == "am":
            out["audio"], dc = dc_blocker(torch.sqrt(p_inst), dc)
        elif self.demod == "ssb":
            n_out = yr.shape[-1]
            pos = torch.arange(n_out, dtype=torch.int64, device=yr.device)
            mr, mi = mix(yr, yi, state.nco, self._incs_t, pos)
            audio, tail_r, tail_i = ssb_filter_demod_planar(mr, mi, self._w_ssb, tail_r, tail_i)
            out["audio"], env = agc_ops.agc_run(audio, self._agc, env)
            nco = nco_ops.advance_phase(state.nco, n_out, self._incs_t)
        return out, ChannelizedState(pfb=pfb_state, dc=dc, power=power, nco=nco,
                                     tail_r=tail_r, tail_i=tail_i, env=env)

    def init_state(self) -> ChannelizedState:
        m, dev = self.m, self.device
        return ChannelizedState(
            pfb=self.pfb.init_state(),
            dc=torch.zeros(m, 2, device=dev),
            power=torch.zeros(m, device=dev),
            nco=torch.zeros(m, dtype=torch.int64, device=dev),
            tail_r=torch.zeros(m, 128, device=dev),
            tail_i=torch.zeros(m, 128, device=dev),
            env=torch.full((m,), 1e-6, device=dev),
        )

    @property
    def segment_multiple(self) -> int:
        """Smallest legal segment length: M for baseband / am / power (one
        PFB frame per output sample), 64*M for ssb (the 2x-rate channel
        streams frame into 128-sample overlap-save blocks)."""
        return 64 * self.m if self.demod == "ssb" else self.m

    def channel_freq(self, k: int, center_freq: float = 0.0) -> float:
        """RF centre of channel k (k >= M/2 wraps to negative offsets)."""
        off = k * self.sample_rate / self.m
        if k >= self.m // 2:
            off -= self.sample_rate
        return center_freq + off

    def _check_len(self, n: int) -> None:
        m = self.segment_multiple
        if n % m:
            if self.demod == "ssb":
                reason = ("64*M: 2x-rate channel streams must frame into "
                          "128-sample overlap-save blocks")
            else:
                reason = "M: one PFB frame per channel-rate sample"
            raise ValueError(
                f"segment length {n} must be a multiple of {m} ({reason}); "
                f"truncate or pad to n={n - n % m or m}, or construct the "
                f"bank with buffer_remainder=True")

    def process(self, iq, state: ChannelizedState):
        """One segment of complex IQ (n,), numpy or a tensor (a real input is
        the I plane with a zero Q plane)."""
        if not torch.is_tensor(iq):
            iq = torch.from_numpy(np.ascontiguousarray(iq))
        iq = iq.to(self.device)
        if iq.is_complex():
            xr, xi = iq.real.float().contiguous(), iq.imag.float().contiguous()
        else:
            xr = iq.float()
            xi = torch.zeros_like(xr)
        return self.process_planar(xr, xi, state)

    def process_planar(self, xr, xi, state: ChannelizedState):
        xr = torch.as_tensor(xr, dtype=torch.float32, device=self.device)
        xi = torch.as_tensor(xi, dtype=torch.float32, device=self.device)
        if not self.buffer_remainder:
            self._check_len(xr.shape[-1])
            return self._fn(state, xr, xi)
        # the unaligned tail waits for the next call; the outputs cover the
        # largest aligned prefix (possibly 0 samples), and no sample is lost
        if self._pending is not None:
            xr = torch.cat([self._pending[0], xr], dim=-1)
            xi = torch.cat([self._pending[1], xi], dim=-1)
            self._pending = None
        m = self.segment_multiple
        n_ok = xr.shape[-1] - xr.shape[-1] % m
        if n_ok < xr.shape[-1]:
            self._pending = (xr[..., n_ok:], xi[..., n_ok:])
            xr, xi = xr[..., :n_ok], xi[..., :n_ok]
        if n_ok == 0:
            empty = {k: torch.zeros(self.m, 0, device=self.device) for k in _OUT_KEYS}
            empty["power"] = state.power
            if self.demod in ("am", "ssb"):
                empty["audio"] = torch.zeros(self.m, 0, device=self.device)
            return empty, state
        return self._fn(state, xr, xi)

    @property
    def pending_samples(self) -> int:
        """Input samples buffered awaiting alignment (buffer_remainder)."""
        return 0 if self._pending is None else self._pending[0].shape[-1]
