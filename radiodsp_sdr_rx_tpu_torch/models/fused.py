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

``FusedSAMBank`` (:581-848) runs synchronous AM: staged (``fold=False``) on
the PLL kernel K5 and K2b, folded on K6 (one launch per segment, up to 128
channels, the blanker included) or, for wider banks, on K7, which runs
several channels' PLLs side by side; its ``FusedSAMBankState`` carries the
PLL and the DC blocker.

``FusedNRBank`` (:217-579) adds a noise-reduction stage to every mode:
``fold=True`` (the default) runs the whole chain with its NR stage folded
into ONE kernel launch per segment, SSB + spectral NR without the blanker
on K4 (ops/sweep_spec.sweep_spec_chain), every other route on the NR
instantiations of the lanes kernel K6 (ops/lanes.sweep_lanes_chain);
``fold=False`` stages the SSB modes: the DNR (lms) route runs the sweep
kernel without R, then the LMS kernel, the notch route runs mix + demod, the
LMS kernel, the AGC and PBT, and the spectral route runs the sweep kernel,
then the plain-PyTorch spectral subtraction.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.models.config import DemodMode, ReceiverConfig
from radiodsp_sdr_rx_tpu_torch.models.receiver import LMS_MAX_CHANNELS, build_params
from radiodsp_sdr_rx_tpu_torch.ops import agc as agc_ops
from radiodsp_sdr_rx_tpu_torch.ops import lanes, lms_bank, nco, planar, sam, sam_wide, staged
from radiodsp_sdr_rx_tpu_torch.ops.iir import dc_blocker
from radiodsp_sdr_rx_tpu_torch.ops.lms import LMS_DELAY, LMS_TAPS
from radiodsp_sdr_rx_tpu_torch.ops.spectral_sub import spectral_matmul_ops
from radiodsp_sdr_rx_tpu_torch.ops.sweep import (
    LmsArgs,
    SamArgs,
    SpecArgs,
    ssb_image,
    sweep_am_chain,
    sweep_full_chain,
    sweep_sam_chain,
)
from radiodsp_sdr_rx_tpu_torch.ops.sweep_spec import sweep_spec_chain
from radiodsp_sdr_rx_tpu_torch.utils.convert import params_from_numpy, resolve_device, split_iq
from radiodsp_sdr_rx_tpu_torch.utils.profiling import span

_BLOCK = 128
_LANES = 128   # the JAX SAM PLL's lane width (pallas_sam.LANES)
_JAX_DUMMY_TAPS = 8   # the JAX lanes wrapper's LMS taps off the LMS stages (pallas_chain_lanes.py:847)


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


def _host_bytes(x, out: torch.Tensor) -> int:
    """The bytes of ``out`` that crossed from the host to make it from ``x``."""
    on_host = not torch.is_tensor(x) or x.device.type == "cpu"
    return out.numel() * out.element_size() if on_host and out.device.type != "cpu" else 0


def _planar(xr, xi, device):
    """The planes as contiguous f32 tensors on ``device``: the upload, which
    waits for its copy from the host."""
    with span("rdsp.upload") as s:
        out = (torch.as_tensor(xr, dtype=torch.float32, device=device).contiguous(),
               torch.as_tensor(xi, dtype=torch.float32, device=device).contiguous())
        if s is not None:
            s.attrs["bytes"] = _host_bytes(xr, out[0]) + _host_bytes(xi, out[1])
    return out


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
        # the sweep kernel without the blanker reads its operators pre-split
        # (ops/sweep.ssb_image), built once here
        self.image = None if backend == "staged" or config.noise_blanker else \
            ssb_image(p.w_ssb, p.w_pbt)

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
        with span("rdsp.entry", bank=type(self).__name__):
            xr, xi = _planar(xr, xi, self.device)
            if self.backend == "staged":
                with span("rdsp.chain"):
                    audio = staged.fused_mix_filter_demod(*self.mix_demod_args(xr, xi, state))
                    audio_g, env = agc_ops.agc_run(audio, self.agc_params, state.agc_env)
                    del audio
                    l, r = staged.pbt_filter(*self.pbt_args(audio_g, state))
                with span("rdsp.state"):
                    new_state = state._replace(
                        nco_phase=nco.advance_phase(state.nco_phase, xr.shape[-1], self.incs),
                        sb_tail=torch.cat([xr[:, -_BLOCK:] * float(self.gain_i),
                                           xi[:, -_BLOCK:] * float(self.gain_q)], dim=-1),
                        audio_tail=audio_g[:, -_BLOCK:].contiguous(),
                        agc_env=env)
                return {"audio_l": l, "audio_r": r}, new_state
            args = self.chain_args(xr, xi, state)
            with span("rdsp.chain"):
                l, r, atail, env, *nb_carry = sweep_full_chain(*args, image=self.image)
            with span("rdsp.state"):
                new_state = state._replace(
                    nco_phase=nco.advance_phase(state.nco_phase, xr.shape[-1], self.incs),
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
        with span("rdsp.entry", bank=type(self).__name__):
            xr, xi = _planar(xr, xi, self.device)
            args = self.chain_args(xr, xi, state)
            with span("rdsp.chain"):
                l, r, atail, env, dc, *nb_carry = sweep_am_chain(*args)
            with span("rdsp.state"):
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


class FusedSAMBankState(NamedTuple):
    """Carry of the SAM bank; fields and meaning as the JAX
    ``FusedSAMBankState``. DDS words are int64 in [0, 2^32). The PLL planes
    are padded to the JAX bank's lanes (128, or a multiple of 128 with
    ``fold=True``); the padded entries pass through unchanged (the JAX PLL
    keeps them at 0 on their zero input).

    ``sb_tail`` differs by backend, so a state of one is not valid for the
    other: ``fold=True`` stores the RAW input's last block [re|im], which the
    kernel re-scales and re-mixes; ``fold=False`` stores the MIXED stream's
    last block.
    """

    nco_phase: torch.Tensor   # (C,) int64 DDS phase words
    sb_tail: torch.Tensor     # (C, 256) f32 input last block [re|im] (see above)
    audio_tail: torch.Tensor  # (C, 128) f32 PBT framing tail (post-AGC audio)
    agc_env: torch.Tensor     # (C,) f32
    nb_avg: torch.Tensor      # (C,) f32 noise-blanker running average
    nb_mask: torch.Tensor     # (C, 128) f32 noise-blanker keep mask of the last block
    sam_phase: torch.Tensor   # (lanes,) f32 PLL phase
    sam_freq: torch.Tensor    # (lanes,) f32 PLL frequency
    sam_dc: torch.Tensor      # (C, 2) f32 DC-blocker carry


class FusedSAMBank:
    """Many-channel synchronous-AM receiver (``fused.py:587-848`` of the JAX
    package), three routes:

      - ``fold=False`` (staged): input gains, the DDS mix and the complex
        band-pass in plain PyTorch, the PLL on K5 (``ops/sam.sam_pll_run``),
        the DC blocker and the AGC in plain PyTorch, PBT on K2b
        (``staged.pbt_filter``) with the output gain: one launch of each per
        segment; up to 128 channels, no blanker.
      - ``fold=True`` up to 128 channels, or whenever the lane groups
        (channels padded to 128) have no divisor among 8, 4, 2, or
        ``wide_groups=1``: the whole chain, the blanker folded in when the
        config asks for it, in ONE launch of K6 per segment
        (``ops/sweep.sweep_sam_chain``).
      - ``fold=True`` otherwise: the same chain on K7
        (``ops/sam_wide.sweep_sam_wide``), ``groups`` = the JAX bank's
        ``g_wide`` (8, 4 or 2; ``wide_groups`` overrides it), one launch per
        segment.

    Every route re-seeds the PLL's oscillator as its JAX twin does: every
    ``sam_chunk`` samples (4,096 by default) staged; folded, per JAX kernel
    call, the ``max_kernel_seg`` sub-segments and their remainder, every
    ``lanes_chunk(., sam_chunk)`` samples on K6 and every
    ``even_chunks(., min(sam_chunk, 256))`` on K7 (``sam.reseed_schedule``).
    The port runs each segment in one launch all the same. The JAX
    ``ValueError``s stay: mode not SAM, NR on, the blanker with
    ``fold=False``, more than 128 channels with ``fold=False``. ``mute`` is
    not read, as in every JAX fused bank. ``device=None`` means the CUDA card
    and raises without one; pass ``device="cpu"`` to run the plain PyTorch
    versions.
    """

    def __init__(self, config: ReceiverConfig, freqs_hz, sam_chunk: int | None = None,
                 max_kernel_seg: int = 1 << 16, fold: bool = True,
                 wide_groups: int | None = None, device=None):
        if sam_chunk is None:
            sam_chunk = 1024 if fold else 4096
        if config.mode != DemodMode.SAM:
            raise ValueError("FusedSAMBank covers SAM; use FusedAMBank or ReceiverBank")
        if config.nr.kind != "off":
            raise ValueError("SAM + NR runs on FusedNRBank")
        if config.noise_blanker and not fold:
            raise ValueError("the noise blanker folds into the kernels (fold=True); the "
                             "staged oracle is ReceiverBank")
        if len(freqs_hz) > _LANES and not fold:
            raise ValueError(f"FusedSAMBank supports <= {_LANES} channels on the staged "
                             "path (fold=True lifts the ceiling)")
        c = len(freqs_hz)
        self.lanes = max(_LANES, -(-c // _LANES) * _LANES) if fold else _LANES
        groups = 1
        if fold:
            groups = max(g for g in (8, 4, 2, 1) if (self.lanes // _LANES) % g == 0)
            if wide_groups is not None:
                if (self.lanes // _LANES) % wide_groups:
                    raise ValueError(f"wide_groups {wide_groups} does not divide "
                                     f"{self.lanes // _LANES} lane groups")
                groups = wide_groups
        self.groups = groups
        self.route = "staged" if not fold else "wide" if groups > 1 else "lanes"
        self.config = config
        self.fold = fold
        self.sam_chunk = int(sam_chunk)
        self.max_kernel_seg = int(max_kernel_seg)
        self.device = resolve_device(device)
        self.n_channels = c
        self.params = p = params_from_numpy(build_params(config)._asdict(), self.device)
        self.agc_params = agc_ops.AGCParams(
            release=p.agc_release, target=p.agc_target,
            max_gain=p.agc_max_gain, enabled=p.agc_enabled)
        # the staged route's input gains, multiplied in f32 as the JAX bank does
        self.gain_i = np.float32(p.input_gain)
        self.gain_q = self.gain_i * np.float32(p.iq_gain_balance)
        self.incs = _phase_incs(config, freqs_hz, self.device)

    def init_state(self) -> FusedSAMBankState:
        c, dev = self.n_channels, self.device
        return FusedSAMBankState(
            nco_phase=torch.zeros(c, dtype=torch.int64, device=dev),
            sb_tail=torch.zeros(c, 2 * _BLOCK, device=dev),
            audio_tail=torch.zeros(c, _BLOCK, device=dev),
            agc_env=torch.full((c,), 1e-6, device=dev),
            nb_avg=torch.zeros(c, device=dev),
            nb_mask=torch.ones(c, _BLOCK, device=dev),
            sam_phase=torch.zeros(self.lanes, device=dev),
            sam_freq=torch.zeros(self.lanes, device=dev),
            sam_dc=torch.zeros(c, 2, device=dev),
        )

    def reseed_schedule(self, n: int) -> sam.Reseed:
        """Where the folded routes re-seed the PLL in a segment of n samples:
        as the JAX bank's kernel calls do (``sam.reseed_schedule``)."""
        wide = self.route == "wide"
        return sam.reseed_schedule(n, min(self.sam_chunk, 256) if wide else self.sam_chunk,
                                   self.max_kernel_seg, wide)

    def chain_args(self, xr: torch.Tensor, xi: torch.Tensor, state: FusedSAMBankState,
                   reseed: sam.Reseed | None = None) -> tuple:
        """The positional arguments of ``sweep_sam_chain`` (route "lanes") or
        ``sweep_sam_wide`` (route "wide") for one segment (``fold=True``);
        ``reseed`` defaults to this segment's ``reseed_schedule``."""
        p, cfg, c = self.params, self.config, self.n_channels
        pll0 = torch.stack([state.sam_phase[:c], state.sam_freq[:c]])
        args = (xr, xi, self.incs, state.nco_phase, p.w_sideband, p.w_pbt,
                state.sb_tail[:, :_BLOCK].contiguous(), state.sb_tail[:, _BLOCK:].contiguous(),
                state.audio_tail, state.agc_env, state.sam_dc, pll0,
                p.agc_release, p.agc_target, p.agc_max_gain, p.agc_enabled,
                p.output_gain, p.input_gain, cfg.iq_gain_balance,
                bool(cfg.noise_blanker), float(cfg.nb_threshold_db),
                float(cfg.nb_tau_samples), state.nb_avg, state.nb_mask)
        if reseed is None:
            reseed = self.reseed_schedule(xr.shape[-1])
        groups = (self.groups,) if self.route == "wide" else ()
        return args + groups + (reseed, 100.0, cfg.sample_rate)

    def pll_args(self, xr: torch.Tensor, xi: torch.Tensor,
                 state: FusedSAMBankState) -> tuple:
        """The staged route's front end (input gains, DDS mix, band-pass) on
        one segment: the positional arguments of ``sam_pll_run``, then the
        mixed last block (the next ``sb_tail``)."""
        c = self.n_channels
        xr, xi = xr * float(self.gain_i), xi * float(self.gain_q)
        xr, xi, _ = planar.nco_mix_planar(xr, xi, state.nco_phase, self.incs)
        zr, zi, tr, ti = planar.overlap_save_filter_planar(
            xr, xi, self.params.w_sideband, state.sb_tail[:, :_BLOCK], state.sb_tail[:, _BLOCK:])
        return ((zr.contiguous(), zi.contiguous(), state.sam_phase[:c], state.sam_freq[:c],
                 100.0, self.config.sample_rate, self.sam_chunk),
                torch.cat([tr, ti], dim=-1))

    def _padded(self, pll, state: FusedSAMBankState) -> dict:
        c = self.n_channels
        return dict(sam_phase=torch.cat([pll[0], state.sam_phase[c:]]),
                    sam_freq=torch.cat([pll[1], state.sam_freq[c:]]))

    def process_planar(self, xr, xi, state: FusedSAMBankState):
        """One segment of planar f32 IQ, (C, n) each with n a multiple of 128.
        Returns ({"audio_l", "audio_r"}, next state)."""
        with span("rdsp.entry", bank=type(self).__name__):
            xr, xi = _planar(xr, xi, self.device)
            if not self.fold:
                with span("rdsp.chain"):
                    pll_args, sb_tail = self.pll_args(xr, xi, state)
                    vr, ph, fr = sam.sam_pll_run(*pll_args)
                    audio, dc = dc_blocker(vr, state.sam_dc)
                    audio, env = agc_ops.agc_run(audio, self.agc_params, state.agc_env)
                    l, r = staged.pbt_filter(audio, self.params.w_pbt, state.audio_tail,
                                             self.params.output_gain)
                with span("rdsp.state"):
                    new_state = state._replace(
                        nco_phase=nco.advance_phase(state.nco_phase, xr.shape[-1], self.incs),
                        sb_tail=sb_tail, audio_tail=audio[:, -_BLOCK:].contiguous(),
                        agc_env=env, sam_dc=dc, **self._padded((ph, fr), state))
                return {"audio_l": l, "audio_r": r}, new_state
            run = sam_wide.sweep_sam_wide if self.route == "wide" else sweep_sam_chain
            args = self.chain_args(xr, xi, state)
            with span("rdsp.chain"):
                l, r, atail, env, dc, pll, *nb_carry = run(*args)
            with span("rdsp.state"):
                new_state = state._replace(
                    nco_phase=nco.advance_phase(state.nco_phase, xr.shape[-1], self.incs),
                    sb_tail=torch.cat([xr[:, -_BLOCK:], xi[:, -_BLOCK:]], dim=-1),
                    audio_tail=atail, agc_env=env, sam_dc=dc, **self._padded(pll, state))
                if nb_carry:
                    new_state = new_state._replace(nb_avg=nb_carry[0], nb_mask=nb_carry[1])
            return {"audio_l": l, "audio_r": r}, new_state

    def process(self, iq, state: FusedSAMBankState):
        """Complex IQ at the host boundary: (C, n), or (n,) for every channel."""
        return self.process_planar(*split_iq(iq, self.n_channels), state)


class FusedNRBankState(NamedTuple):
    """Carry of the NR bank; fields, shapes and meaning as the JAX
    ``FusedNRBankState``, with the leading channel axis. DDS words are int64
    in [0, 2^32). The LMS rows and the PLL planes are padded to the JAX
    bank's lanes (128, or on the lanes routes the channels rounded up to a
    multiple of 128); the padded rows carry zeros, which the LMS and the PLL
    keep at zero. ``lms_first`` is one bool for the whole bank, as in JAX.
    ``dc``, ``pll``, ``nb_avg`` and ``nb_mask`` belong to the lanes routes;
    the other routes carry them unchanged.

    ``sb_tail`` differs by route, so a state of one route is not valid for
    the other: ``fold=True`` stores the RAW input's last block [re|im], which
    the kernel re-scales and re-mixes; ``fold=False`` scales the input by the
    input gain and IQ balance before any kernel and stores the SCALED, unmixed
    last block.
    """

    nco_phase: torch.Tensor    # (C,) int64 DDS phase words
    sb_tail: torch.Tensor      # (C, 256) f32 input last block [re|im] (see above)
    audio_tail: torch.Tensor   # (C, 128) f32 PBT framing tail (post-AGC audio)
    agc_env: torch.Tensor      # (C,) f32
    lms_weights: torch.Tensor  # (lanes, 96) f32, rows past C zero ((lanes, 8) zeros
    lms_window: torch.Tensor   # (lanes, 96) f32   after a lanes route without LMS)
    lms_delay: torch.Tensor    # (lanes, 128) f32
    lms_first: torch.Tensor    # () bool, the reference's first-block quirk
    nfloor: torch.Tensor       # (C,) f32 spectral-subtraction noise floor
    spec_tail_l: torch.Tensor  # (C, 128) f32 spectral-subtraction frame carries
    spec_tail_r: torch.Tensor  # (C, 128) f32
    dc: torch.Tensor           # (C, 2) f32 AM/SAM DC-blocker carry
    pll: torch.Tensor          # (2, lanes) f32 SAM PLL [phase | freq]
    nb_avg: torch.Tensor       # (C,) f32 noise-blanker running average
    nb_mask: torch.Tensor      # (C, 128) f32 noise-blanker keep mask of the last block


class FusedNRBank:
    """Many-channel receiver with a noise-reduction stage (``fused.py:217-579``
    of the JAX package); the output gain comes after the NR stage, as in
    ``rx_chain``. Routes (``route``):

      - "spec": ``fold=True``, an SSB mode, spectral NR (SPEC1-4), no
        blanker: the whole chain in ONE launch of K4 per segment
        (``ops/sweep_spec.sweep_spec_chain``).
      - "lanes": ``fold=True``, every other mode x NR x blanker: the whole
        chain in ONE launch per segment of the lanes kernel's instantiation
        (``ops/lanes.sweep_lanes_chain``; ``kernel`` names it), as the JAX
        bank's ``fn_lanes``: DNR (the LMS prediction of L after PBT, x1.1,
        R <- L), notch (the LMS error before the AGC) or spectral NR after
        any demod, AM and SAM on the complex band-pass (``w_sideband``),
        the blanker folded in. Unused carries come back as the JAX kernel
        returns them: the LMS rows and ``pll`` zero off their stages (the
        weights and window then (lanes, 8), the JAX wrapper's dummy taps),
        ``dc`` zero on SSB; ``nfloor``, the spectral tails and the blanker's
        carries pass through when their stage is off; ``lms_first`` turns
        False. SAM re-seeds its PLL every ``sam.even_chunks(n, 1024)``
        samples, the JAX bank's chunk for SAM with NR.
      - "staged": ``fold=False``, SSB modes only. DNR1-4: the sweep kernel
        without R, with unit output gain (``sweep_full_chain(emit_r=False)``),
        the LMS kernel in denoise mode (``ops/lms_bank``), x1.1 makeup,
        R <- L, output gain. Notch: mix + demod
        (``staged.fused_mix_filter_demod``), the LMS kernel in notch mode,
        the AGC (``agc.agc_run``), PBT with the output gain
        (``staged.pbt_filter``). Spectral: the sweep kernel with unit output
        gain, then ``planar.spectral_subtract_planar``, output gain. It
        scales the input before any kernel, so every kernel of that route
        runs with unit input gain and balance.

    The JAX ``ValueError``s stay: NR off, the blanker or AM/SAM with
    ``fold=False``, more than 128 channels with ``fold=False``.
    ``device=None`` means the CUDA card and raises without one; pass
    ``device="cpu"`` to run the plain PyTorch versions.
    """

    def __init__(self, config: ReceiverConfig, freqs_hz, fold: bool = True, device=None):
        kind = config.nr.kind
        if kind not in ("lms", "spectral", "notch"):
            raise ValueError("FusedNRBank needs an NR config; use FusedSSBBank for nr=off")
        if config.noise_blanker and not fold:
            raise ValueError("the noise blanker folds into the lanes kernel (fold=True); "
                             "the staged oracle is ReceiverBank")
        self.demod = {DemodMode.AM: "am", DemodMode.SAM: "sam"}.get(config.mode, "ssb")
        if self.demod != "ssb" and not fold:
            raise ValueError("AM/SAM + NR run on the folded lanes kernel (fold=True); "
                             "the staged oracle is ReceiverBank")
        if len(freqs_hz) > LMS_MAX_CHANNELS and not fold:
            raise ValueError(f"FusedNRBank supports <= {LMS_MAX_CHANNELS} channels on the "
                             "staged path (fold=True lifts the ceiling)")
        c = len(freqs_hz)
        self.nr = {"lms": "denoise", "notch": "notch", "spectral": "spectral"}[kind]
        if not fold:
            self.route, self.kernel = "staged", None
        elif kind == "spectral" and self.demod == "ssb" and not config.noise_blanker:
            self.route, self.kernel = "spec", "sweep_spec_chain"
        else:
            self.route = "lanes"
            self.kernel = lanes.kernel_name(self.demod, self.nr, bool(config.noise_blanker))
        # the JAX lanes kernel grids over 128-channel lane groups: its LMS and
        # PLL carries have the channels rounded up
        self.lanes = max(_LANES, -(-c // _LANES) * _LANES) if self.route == "lanes" \
            else LMS_MAX_CHANNELS
        self.config = config
        self.device = resolve_device(device)
        self.n_channels = c
        self.params = p = params_from_numpy(build_params(config)._asdict(), self.device)
        self.agc_params = agc_ops.AGCParams(
            release=p.agc_release, target=p.agc_target,
            max_gain=p.agc_max_gain, enabled=p.agc_enabled)
        # fold=False scales before any kernel, in f32 as the JAX bank does
        self.gain_i = np.float32(p.input_gain)
        self.gain_q = self.gain_i * np.float32(p.iq_gain_balance)
        self.incs = _phase_incs(config, freqs_hz, self.device)
        if fold and kind == "spectral":
            self.w_spec = tuple(torch.as_tensor(w, device=self.device)
                                for w in spectral_matmul_ops(config.fft_length))
        # fold=False's sweep kernel (DNR: without R; spectral: with R) reads
        # its operators pre-split (ops/sweep.ssb_image), built once here
        self.image = ssb_image(p.w_ssb, p.w_pbt, emit_r=kind == "spectral") \
            if not fold and kind != "notch" else None

    def init_state(self) -> FusedNRBankState:
        c, lanes, dev = self.n_channels, self.lanes, self.device
        return FusedNRBankState(
            nco_phase=torch.zeros(c, dtype=torch.int64, device=dev),
            sb_tail=torch.zeros(c, 2 * _BLOCK, device=dev),
            audio_tail=torch.zeros(c, _BLOCK, device=dev),
            agc_env=torch.full((c,), 1e-6, device=dev),
            lms_weights=torch.zeros(lanes, LMS_TAPS, device=dev),
            lms_window=torch.zeros(lanes, LMS_TAPS, device=dev),
            lms_delay=torch.zeros(lanes, LMS_DELAY, device=dev),
            lms_first=torch.ones((), dtype=torch.bool, device=dev),
            nfloor=torch.zeros(c, device=dev),
            spec_tail_l=torch.zeros(c, _BLOCK, device=dev),
            spec_tail_r=torch.zeros(c, _BLOCK, device=dev),
            dc=torch.zeros(c, 2, device=dev),
            pll=torch.zeros(2, lanes, device=dev),
            nb_avg=torch.zeros(c, device=dev),
            nb_mask=torch.ones(c, _BLOCK, device=dev),
        )

    def spec_args(self, xr: torch.Tensor, xi: torch.Tensor,
                  state: FusedNRBankState) -> tuple:
        """The positional arguments of ``sweep_spec_chain`` for one segment
        (route "spec")."""
        p, cfg = self.params, self.config
        return (xr, xi, self.incs, state.nco_phase, p.w_ssb, p.w_pbt, *self.w_spec,
                state.sb_tail[:, :_BLOCK].contiguous(), state.sb_tail[:, _BLOCK:].contiguous(),
                state.audio_tail, state.agc_env, state.nfloor, state.spec_tail_l,
                state.spec_tail_r, p.nr_level, p.agc_release, p.agc_target, p.agc_max_gain,
                p.agc_enabled, p.output_gain, p.input_gain, cfg.iq_gain_balance)

    def _lms(self, audio, state: FusedNRBankState, mode: str):
        """K3 on the bank's C rows; the padded rows pass through."""
        c = self.n_channels
        out, w, win, dly = lms_bank.lms_nr_run_bank(
            audio, state.lms_weights[:c], state.lms_window[:c], state.lms_delay[:c],
            state.lms_first, self.params.lms_mu, mode)

        def padded(new, old):
            return torch.cat([new, old[c:]]) if c < old.shape[0] else new

        return out, dict(lms_weights=padded(w, state.lms_weights),
                         lms_window=padded(win, state.lms_window),
                         lms_delay=padded(dly, state.lms_delay),
                         lms_first=torch.zeros_like(state.lms_first))

    def _staged(self, xr, xi, state: FusedNRBankState):
        p, kind = self.params, self.config.nr.kind
        xr, xi = xr * float(self.gain_i), xi * float(self.gain_q)
        upd = dict(sb_tail=torch.cat([xr[:, -_BLOCK:], xi[:, -_BLOCK:]], dim=-1))
        if kind == "notch":   # the notch precedes the AGC
            audio = staged.fused_mix_filter_demod(xr, xi, self.incs, state.nco_phase,
                                                  p.w_ssb, state.sb_tail)
            audio, lms_upd = self._lms(audio, state, "notch")
            audio, env = agc_ops.agc_run(audio, self.agc_params, state.agc_env)
            l, r = staged.pbt_filter(audio, p.w_pbt, state.audio_tail, p.output_gain)
            upd.update(lms_upd, audio_tail=audio[:, -_BLOCK:].contiguous(), agc_env=env)
            return {"audio_l": l, "audio_r": r}, upd
        l, r, atail, env = sweep_full_chain(
            xr, xi, self.incs, state.nco_phase, p.w_ssb, p.w_pbt,
            state.sb_tail[:, :_BLOCK].contiguous(), state.sb_tail[:, _BLOCK:].contiguous(),
            state.audio_tail, state.agc_env, p.agc_release, p.agc_target, p.agc_max_gain,
            p.agc_enabled, emit_r=kind == "spectral", image=self.image)
        upd.update(audio_tail=atail, agc_env=env)
        og = p.output_gain
        if kind == "lms":
            l, lms_upd = self._lms(l, state, "denoise")
            upd.update(lms_upd)
            l = l * float(np.float32(1.1)) * og   # makeup (RDSP_convolutional.h:334)
            return {"audio_l": l, "audio_r": l}, upd   # mono copy R<-L (:335)
        l, r, nfloor, spec_l, spec_r = planar.spectral_subtract_planar(
            l, r, p.nr_level, state.nfloor, p.dft_cos, p.dft_sin,
            state.spec_tail_l, state.spec_tail_r)
        upd.update(nfloor=nfloor, spec_tail_l=spec_l, spec_tail_r=spec_r)
        return {"audio_l": l * og, "audio_r": r * og}, upd

    def lanes_args(self, xr: torch.Tensor, xi: torch.Tensor,
                   state: FusedNRBankState) -> tuple:
        """The positional arguments of ``lanes.sweep_lanes_chain`` for one
        segment (route "lanes")."""
        p, cfg, c = self.params, self.config, self.n_channels
        dsb = self.demod != "ssb"
        sam_a = lms_a = spec_a = None
        if self.demod == "sam":
            # the JAX bank's chunk for SAM with NR, 1024 samples: one re-seed
            # per chunk, and no halving of an odd chunk count
            sam_a = SamArgs(state.pll[:, :c].contiguous(), sam.pll_gains(100.0, cfg.sample_rate),
                            sam.reseed_schedule(xr.shape[-1], 1024, wide=True))
        if self.nr == "spectral":
            spec_a = SpecArgs(*self.w_spec, state.nfloor, state.spec_tail_l, state.spec_tail_r,
                              p.nr_level)
        else:
            lms_a = LmsArgs(state.lms_weights[:c], state.lms_window[:c], state.lms_delay[:c],
                            state.lms_first, p.lms_mu, self.nr)
        return (xr, xi, self.incs, state.nco_phase, p.w_sideband if dsb else p.w_ssb, p.w_pbt,
                state.sb_tail[:, :_BLOCK].contiguous(), state.sb_tail[:, _BLOCK:].contiguous(),
                state.audio_tail, state.agc_env, p.agc_release, p.agc_target, p.agc_max_gain,
                p.agc_enabled, p.output_gain, p.input_gain, cfg.iq_gain_balance,
                bool(cfg.noise_blanker), float(cfg.nb_threshold_db), float(cfg.nb_tau_samples),
                state.nb_avg, state.nb_mask, state.dc if dsb else None, sam_a, lms_a, spec_a)

    def _lanes_state(self, out: lanes.LanesOut, state: FusedNRBankState):
        """The outputs and the state's updates from a lanes chain's ``out``:
        the carries padded to the bank's lanes as the JAX wrapper returns
        them."""

        def padded(new, like):
            """new (C, ...) in the first rows of zeros shaped as ``like``
            (lanes, ...): zeros for the padded rows, all zeros where the
            stage did not run (new None)."""
            full = torch.zeros_like(like)
            if new is not None:
                full[:new.shape[0]] = new
            return full

        pll_t = padded(None if out.pll is None else out.pll.T, state.pll.T)
        # off the LMS stages the JAX wrapper returns its dummy weights and
        # window, (lanes, 8) zeros
        taps = state.lms_weights if out.lms_weights is not None else \
            state.lms_weights.new_empty((self.lanes, _JAX_DUMMY_TAPS))
        upd = dict(audio_tail=out.audio_tail, agc_env=out.agc_env,
                   lms_weights=padded(out.lms_weights, taps),
                   lms_window=padded(out.lms_window, taps),
                   lms_delay=padded(out.lms_delay, state.lms_delay),
                   lms_first=torch.zeros_like(state.lms_first),
                   dc=padded(out.dc, state.dc), pll=pll_t.T.contiguous())
        if out.nfloor is not None:
            upd.update(nfloor=out.nfloor, spec_tail_l=out.spec_tail_l,
                       spec_tail_r=out.spec_tail_r)
        if out.nb_avg is not None:
            upd.update(nb_avg=out.nb_avg, nb_mask=out.nb_mask)
        r = out.audio_l if self.nr == "denoise" else out.audio_r   # mono copy R<-L
        return {"audio_l": out.audio_l, "audio_r": r}, upd

    def process_planar(self, xr, xi, state: FusedNRBankState):
        """One segment of planar f32 IQ, (C, n) each with n a multiple of 128.
        Returns ({"audio_l", "audio_r"}, next state)."""
        with span("rdsp.entry", bank=type(self).__name__):
            xr, xi = _planar(xr, xi, self.device)
            n = xr.shape[-1]
            if self.route == "staged":
                with span("rdsp.chain"):
                    out, upd = self._staged(xr, xi, state)
                with span("rdsp.state"):
                    new_state = state._replace(
                        nco_phase=nco.advance_phase(state.nco_phase, n, self.incs), **upd)
                return out, new_state
            if self.route == "lanes":
                args = self.lanes_args(xr, xi, state)
                with span("rdsp.chain"):
                    res = lanes.sweep_lanes_chain(*args)
                with span("rdsp.state"):
                    out, upd = self._lanes_state(res, state)
                    new_state = state._replace(
                        nco_phase=nco.advance_phase(state.nco_phase, n, self.incs),
                        sb_tail=torch.cat([xr[:, -_BLOCK:], xi[:, -_BLOCK:]], dim=-1), **upd)
                return out, new_state
            args = self.spec_args(xr, xi, state)
            with span("rdsp.chain"):
                l, r, atail, env, nfloor, spec_l, spec_r = sweep_spec_chain(*args)
            with span("rdsp.state"):
                new_state = state._replace(
                    nco_phase=nco.advance_phase(state.nco_phase, n, self.incs),
                    sb_tail=torch.cat([xr[:, -_BLOCK:], xi[:, -_BLOCK:]], dim=-1),
                    audio_tail=atail, agc_env=env, nfloor=nfloor, spec_tail_l=spec_l,
                    spec_tail_r=spec_r)
            return {"audio_l": l, "audio_r": r}, new_state

    def process(self, iq, state: FusedNRBankState):
        """Complex IQ at the host boundary: (C, n), or (n,) for every channel."""
        return self.process_planar(*split_iq(iq, self.n_channels), state)
