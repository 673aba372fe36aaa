"""Many-channel fused receiver banks (``radiodsp_sdr_rx_tpu/models/fused.py``).

``FusedSSBBank`` (:43-190) has two backends, selected by ``backend=``, as in
the JAX package:

  - "sweep" (default): the whole chain (NCO mix, sideband filter + SSB
    demod, AGC, PBT) for every channel in ONE kernel launch per segment
    (ops/sweep.sweep_full_chain). With ``config.noise_blanker`` the kernel's
    nb variant blanks impulses before the mix, still one launch.
  - "staged": two kernel launches per segment, mix + filter + demod
    (ops/staged.fused_mix_filter_demod) and PBT (ops/staged.pbt_filter),
    with the AGC between them in PyTorch (ops/agc.agc_run). It writes and
    re-reads the audio twice, so it is the slower backend. The noise
    blanker is the sweep backend's only.

The DDS phase, framing tails, AGC envelope and blanker carries thread from
call to call in a ``FusedBankState``.

``FusedAMBank`` (:871-979) runs the AM chain (NCO mix, complex band-pass,
envelope, DC blocker, AGC, PBT), with or without the blanker, in ONE kernel
launch per segment (ops/sweep.sweep_am_chain); its ``FusedAMBankState``
adds the DC blocker's carry ``am_dc``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.models.config import DemodMode, ReceiverConfig
from radiodsp_sdr_rx_tpu_torch.models.receiver import build_params
from radiodsp_sdr_rx_tpu_torch.ops import agc as agc_ops
from radiodsp_sdr_rx_tpu_torch.ops import nco, staged
from radiodsp_sdr_rx_tpu_torch.ops.sweep import sweep_am_chain, sweep_full_chain
from radiodsp_sdr_rx_tpu_torch.utils.convert import params_from_numpy, resolve_device, split_iq

_BLOCK = 128


class FusedBankState(NamedTuple):
    """Carry of the fused bank; fields and meaning as the JAX
    ``FusedBankState``. DDS words are int64 in [0, 2^32).

    ``sb_tail`` differs by backend, so a state of one backend is not valid
    for the other: the sweep backend stores the RAW input's last block
    [re|im], which its kernel re-scales and re-mixes; the staged backend
    stores that block scaled by the input gain and IQ balance and NOT mixed,
    which its mix + demod kernel mixes at positions -128..-1.
    """

    nco_phase: torch.Tensor   # (C,) int64 DDS phase words
    sb_tail: torch.Tensor     # (C, 256) f32 input last block [re|im] (see above)
    audio_tail: torch.Tensor  # (C, 128) f32 PBT framing tail (post-AGC audio)
    agc_env: torch.Tensor     # (C,) f32
    nb_avg: torch.Tensor      # (C,) f32 noise-blanker running average
    nb_mask: torch.Tensor     # (C, 128) f32 noise-blanker keep mask of the last block


def _phase_incs(config: ReceiverConfig, freqs_hz, device) -> torch.Tensor:
    return torch.as_tensor(nco.bank_phase_incs(config, freqs_hz).astype(np.int64),
                           device=device)


def _planar(xr, xi, device):
    return (torch.as_tensor(xr, dtype=torch.float32, device=device).contiguous(),
            torch.as_tensor(xi, dtype=torch.float32, device=device).contiguous())


class FusedSSBBank:
    """Many-channel fused SSB receiver (USB/LSB/CW/RTTY + AGC).

    ``device=None`` means the CUDA card and raises without one; pass
    ``device="cpu"`` to run the plain PyTorch versions.
    """

    def __init__(self, config: ReceiverConfig, freqs_hz, backend: str = "sweep",
                 device=None):
        if config.mode in (DemodMode.AM, DemodMode.SAM):
            raise ValueError("FusedSSBBank covers SSB modes")
        if config.nr.kind != "off":
            raise ValueError("NR configs are not part of FusedSSBBank")
        if backend not in ("staged", "sweep"):
            raise ValueError(backend)
        if config.noise_blanker and backend != "sweep":
            raise ValueError("the noise blanker folds into the sweep backend "
                             "only; use backend='sweep'")
        self.backend = backend
        self.config = config
        self.device = resolve_device(device)
        self.n_channels = len(freqs_hz)
        self.params = p = params_from_numpy(build_params(config)._asdict(), self.device)
        self.agc_params = agc_ops.AGCParams(
            release=p.agc_release, target=p.agc_target,
            max_gain=p.agc_max_gain, enabled=p.agc_enabled)
        # the staged backend's input gains, multiplied in f32 as the JAX bank does
        self.gain_i = np.float32(p.input_gain)
        self.gain_q = self.gain_i * np.float32(p.iq_gain_balance)
        self.incs = _phase_incs(config, freqs_hz, self.device)

    def init_state(self) -> FusedBankState:
        c, dev = self.n_channels, self.device
        return FusedBankState(
            nco_phase=torch.zeros(c, dtype=torch.int64, device=dev),
            sb_tail=torch.zeros(c, 2 * _BLOCK, device=dev),
            audio_tail=torch.zeros(c, _BLOCK, device=dev),
            agc_env=torch.full((c,), 1e-6, device=dev),
            nb_avg=torch.zeros(c, device=dev),
            nb_mask=torch.ones(c, _BLOCK, device=dev),
        )

    def chain_args(self, xr: torch.Tensor, xi: torch.Tensor,
                   state: FusedBankState) -> tuple:
        """The positional arguments of ``sweep_full_chain`` for one segment
        (sweep backend), the blanker's included."""
        p, cfg = self.params, self.config
        return (xr, xi, self.incs, state.nco_phase, p.w_ssb, p.w_pbt,
                state.sb_tail[:, :_BLOCK].contiguous(),
                state.sb_tail[:, _BLOCK:].contiguous(),
                state.audio_tail, state.agc_env,
                p.agc_release, p.agc_target, p.agc_max_gain, p.agc_enabled,
                p.output_gain, p.input_gain, cfg.iq_gain_balance,
                bool(cfg.noise_blanker), float(cfg.nb_threshold_db),
                float(cfg.nb_tau_samples), state.nb_avg, state.nb_mask)

    def mix_demod_args(self, xr: torch.Tensor, xi: torch.Tensor,
                       state: FusedBankState) -> tuple:
        """The positional arguments of ``fused_mix_filter_demod`` for one
        segment (staged backend)."""
        return (xr, xi, self.incs, state.nco_phase, self.params.w_ssb,
                state.sb_tail, float(self.gain_i), float(self.gain_q))

    def pbt_args(self, audio_g: torch.Tensor, state: FusedBankState) -> tuple:
        """The positional arguments of ``pbt_filter`` for the AGC'd audio of
        one segment (staged backend)."""
        return audio_g, self.params.w_pbt, state.audio_tail, self.params.output_gain

    def process_planar(self, xr, xi, state: FusedBankState):
        """One segment of planar f32 IQ, (C, n) each with n a multiple of 128.
        Returns ({"audio_l", "audio_r"}, next state)."""
        xr, xi = _planar(xr, xi, self.device)
        phase = nco.advance_phase(state.nco_phase, xr.shape[-1], self.incs)
        if self.backend == "staged":
            audio = staged.fused_mix_filter_demod(*self.mix_demod_args(xr, xi, state))
            audio_g, env = agc_ops.agc_run(audio, self.agc_params, state.agc_env)
            del audio
            l, r = staged.pbt_filter(*self.pbt_args(audio_g, state))
            new_state = state._replace(
                nco_phase=phase,
                sb_tail=torch.cat([xr[:, -_BLOCK:] * float(self.gain_i),
                                   xi[:, -_BLOCK:] * float(self.gain_q)], dim=-1),
                audio_tail=audio_g[:, -_BLOCK:].contiguous(),
                agc_env=env)
            return {"audio_l": l, "audio_r": r}, new_state
        l, r, atail, env, *nb_carry = sweep_full_chain(*self.chain_args(xr, xi, state))
        new_state = state._replace(
            nco_phase=phase,
            sb_tail=torch.cat([xr[:, -_BLOCK:], xi[:, -_BLOCK:]], dim=-1),
            audio_tail=atail, agc_env=env)
        if nb_carry:
            new_state = new_state._replace(nb_avg=nb_carry[0], nb_mask=nb_carry[1])
        return {"audio_l": l, "audio_r": r}, new_state

    def process(self, iq, state: FusedBankState):
        """Complex IQ at the host boundary: (C, n), or (n,) for every channel."""
        return self.process_planar(*split_iq(iq, self.n_channels), state)


class FusedAMBankState(NamedTuple):
    """Carry of the fused AM bank; fields and meaning as the JAX
    ``FusedAMBankState``. DDS words are int64 in [0, 2^32)."""

    nco_phase: torch.Tensor   # (C,) int64 DDS phase words
    sb_tail: torch.Tensor     # (C, 256) f32 the RAW input's last block [re|im]
    audio_tail: torch.Tensor  # (C, 128) f32 PBT framing tail (post-AGC audio)
    agc_env: torch.Tensor     # (C,) f32
    am_dc: torch.Tensor       # (C, 2) f32 DC-blocker carry [last envelope, last output]
    nb_avg: torch.Tensor      # (C,) f32 noise-blanker running average
    nb_mask: torch.Tensor     # (C, 128) f32 noise-blanker keep mask of the last block


class FusedAMBank:
    """Many-channel fused AM receiver: NCO mix, complex band-pass, envelope,
    DC blocker, AGC and PBT in ONE kernel launch per segment, the noise
    blanker folded in when the config asks for it.

    ``device=None`` means the CUDA card and raises without one; pass
    ``device="cpu"`` to run the plain PyTorch versions.
    """

    def __init__(self, config: ReceiverConfig, freqs_hz, device=None):
        if config.mode != DemodMode.AM:
            raise ValueError("FusedAMBank covers AM; use FusedSSBBank or ReceiverBank")
        if config.nr.kind != "off":
            raise ValueError("NR configs are not part of FusedAMBank")
        self.config = config
        self.device = resolve_device(device)
        self.n_channels = len(freqs_hz)
        self.params = params_from_numpy(build_params(config)._asdict(), self.device)
        self.incs = _phase_incs(config, freqs_hz, self.device)

    def init_state(self) -> FusedAMBankState:
        c, dev = self.n_channels, self.device
        return FusedAMBankState(
            nco_phase=torch.zeros(c, dtype=torch.int64, device=dev),
            sb_tail=torch.zeros(c, 2 * _BLOCK, device=dev),
            audio_tail=torch.zeros(c, _BLOCK, device=dev),
            agc_env=torch.full((c,), 1e-6, device=dev),
            am_dc=torch.zeros(c, 2, device=dev),
            nb_avg=torch.zeros(c, device=dev),
            nb_mask=torch.ones(c, _BLOCK, device=dev),
        )

    def chain_args(self, xr: torch.Tensor, xi: torch.Tensor,
                   state: FusedAMBankState) -> tuple:
        """The positional arguments of ``sweep_am_chain`` for one segment."""
        p, cfg = self.params, self.config
        return (xr, xi, self.incs, state.nco_phase, p.w_sideband, p.w_pbt,
                state.sb_tail[:, :_BLOCK].contiguous(),
                state.sb_tail[:, _BLOCK:].contiguous(),
                state.audio_tail, state.agc_env, state.am_dc,
                p.agc_release, p.agc_target, p.agc_max_gain, p.agc_enabled,
                p.output_gain, p.input_gain, cfg.iq_gain_balance,
                bool(cfg.noise_blanker), float(cfg.nb_threshold_db),
                float(cfg.nb_tau_samples), state.nb_avg, state.nb_mask)

    def process_planar(self, xr, xi, state: FusedAMBankState):
        """One segment of planar f32 IQ, (C, n) each with n a multiple of 128.
        Returns ({"audio_l", "audio_r"}, next state)."""
        xr, xi = _planar(xr, xi, self.device)
        l, r, atail, env, dc, *nb_carry = sweep_am_chain(*self.chain_args(xr, xi, state))
        new_state = state._replace(
            nco_phase=nco.advance_phase(state.nco_phase, xr.shape[-1], self.incs),
            sb_tail=torch.cat([xr[:, -_BLOCK:], xi[:, -_BLOCK:]], dim=-1),
            audio_tail=atail, agc_env=env, am_dc=dc)
        if nb_carry:
            new_state = new_state._replace(nb_avg=nb_carry[0], nb_mask=nb_carry[1])
        return {"audio_l": l, "audio_r": r}, new_state

    def process(self, iq, state: FusedAMBankState):
        """Complex IQ at the host boundary: (C, n), or (n,) for every channel."""
        return self.process_planar(*split_iq(iq, self.n_channels), state)
