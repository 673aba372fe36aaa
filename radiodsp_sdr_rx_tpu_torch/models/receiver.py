"""The receiver's parameters, state and reference bank chain (``radiodsp_sdr_rx_tpu/models/receiver.py``).

``build_params`` designs every operator in float64 numpy, exactly as the JAX
package does, so the two packages compute from bit-equal operators. The
fields keep the JAX names.

``ReceiverBank`` is the many-channel reference chain: every stage of
``rx_chain_batched`` (:310-460) on (C, n) planes, plain PyTorch as the JAX
chain is XLA, except the adaptive LMS stages, which run the K3 kernel on the
card (``ops/lms_bank.py``). It covers the SSB modes, AM and SAM (the exact
PLL of ``planar.demod_sam_planar``, no kernel, as in JAX), NR off / notch /
lms (DNR1-4), spectral NR (SPEC1-4), the noise blanker, ``quantize_output``
and ``mute``. The conv-first variants raise ``NotImplementedError`` naming
their ROADMAP item; their state fields are carried unchanged, so a JAX state
converts both ways (``utils/convert.py``). The single-channel
``Receiver`` and the per-channel ``rx_chain`` come with ROADMAP item 7.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.models.config import DemodMode, NRMode, ReceiverConfig
from radiodsp_sdr_rx_tpu_torch.ops import agc as agc_ops
from radiodsp_sdr_rx_tpu_torch.ops import fir_design, lms, nco, planar
from radiodsp_sdr_rx_tpu_torch.ops.operators import pbt_operator, ssb_demod_operator
from radiodsp_sdr_rx_tpu_torch.ops.qformat import quantize_q15
from radiodsp_sdr_rx_tpu_torch.utils.convert import params_from_numpy, resolve_device, split_iq


class ReceiverParams(NamedTuple):
    """Pipeline parameters, field for field the JAX ``ReceiverParams``."""

    nco_inc: Any          # uint32 DDS increment; a bank's (C,) int64 tensor
    w_sideband: Any       # (2F, F) f32 collapsed overlap-save operator
    w_ssb: Any            # (2F, F/2) f32 fused sideband filter + SSB demod
    w_pbt: Any            # (F, F) f32 PBT operator -> [L|R]
    w_audio: Any          # (2F, F) f32 audio operator
    dft_cos: Any          # (F, F) f32 DFT matrices (spectral subtraction)
    dft_sin: Any
    agc_release: Any      # f32
    agc_target: Any       # f32
    agc_max_gain: Any     # f32
    agc_enabled: Any      # bool
    lms_mu: Any           # f32 LMS step size (notch and DNR)
    nr_level: Any         # f32
    nb_threshold_db: Any  # f32
    nb_tau: Any           # f32
    input_gain: Any       # f32
    output_gain: Any      # f32
    iq_gain_balance: Any  # f32
    mute: Any             # bool


def build_params(config: ReceiverConfig) -> ReceiverParams:
    """Host-side parameter construction (float64 design, f32 operators)."""
    mask_sb = fir_design.design_filter_mask(
        *config.iq_band, config.sample_rate, config.fft_length,
        window_id=int(config.fir_window))
    mask_audio = fir_design.design_filter_mask(
        config.pbt_lo, config.pbt_hi, config.sample_rate, config.fft_length,
        window_id=int(config.fir_window))
    dft_c, dft_s = planar.dft_matrices(config.fft_length)
    agc_p = agc_ops.agc_presets(
        config.sample_rate, target=config.agc_target,
        max_gain=config.agc_max_gain)[config.agc.value]
    if config.agc_release_s is not None and config.agc.value != "off":
        agc_p = agc_ops.preset_from_release_time(
            config.agc_release_s, config.sample_rate,
            target=config.agc_target, max_gain=config.agc_max_gain)

    return ReceiverParams(
        nco_inc=nco.freq_to_phase_inc(config.nco_freq, config.sample_rate),
        w_sideband=fir_design.overlap_save_matrix_real(mask_sb),
        w_ssb=ssb_demod_operator(mask_sb),
        w_pbt=pbt_operator(mask_audio),
        w_audio=fir_design.overlap_save_matrix_real(mask_audio),
        dft_cos=dft_c,
        dft_sin=dft_s,
        agc_release=np.float32(agc_p.release),
        agc_target=np.float32(agc_p.target),
        agc_max_gain=np.float32(agc_p.max_gain),
        agc_enabled=np.bool_(agc_p.enabled),
        # NOTCH has no menu level (nr_level stays 0, RDSP_controls.h:256-263);
        # the ALS notch uses a moderate fixed adaption strength
        lms_mu=lms.lms_mu_from_strength(config.nr.level if config.nr.level > 0 else 20),
        nr_level=np.float32(config.nr.level),
        nb_threshold_db=np.float32(config.nb_threshold_db),
        nb_tau=np.float32(config.nb_tau_samples),
        input_gain=np.float32(config.input_gain),
        output_gain=np.float32(config.output_gain),
        iq_gain_balance=np.float32(config.iq_gain_balance),
        mute=np.bool_(config.mute),
    )


class ReceiverState(NamedTuple):
    """All carried DSP state of a bank, field for field the JAX
    ``ReceiverState`` with the leading channel axis of the JAX bank's
    stacked state. DDS words are int64 in [0, 2^32)."""

    nco_phase: torch.Tensor     # (C,) int64 DDS phase words
    sb_tail_r: torch.Tensor     # (C, 128) f32 IQ-stage overlap-save carry (mixed)
    sb_tail_i: torch.Tensor     # (C, 128)
    audio_tail: torch.Tensor    # (C, 128) f32 PBT-stage carry
    spec_tail_l: torch.Tensor   # (C, 128) f32 spectral-subtraction carries
    spec_tail_r: torch.Tensor
    agc_env: torch.Tensor       # (C,) f32
    nb_avg: torch.Tensor        # (C,) f32
    am_dc: torch.Tensor         # (C, 2) f32 DC-blocker carry
    sam: planar.SAMStatePlanar
    lms: lms.LMSState
    nfloor: torch.Tensor        # (C,) f32 spectral-subtraction noise floor
    conv_tail_r: torch.Tensor   # (C, 128) f32 conv-first pre-demod carries
    conv_tail_i: torch.Tensor


def init_state(fft_length: int = 256, channels: int = 1, device="cpu") -> ReceiverState:
    """Fresh state of a bank of ``channels`` receivers."""
    half = fft_length // 2

    def zeros(*shape):
        return torch.zeros(channels, *shape, device=device)

    return ReceiverState(
        nco_phase=torch.zeros(channels, dtype=torch.int64, device=device),
        sb_tail_r=zeros(half), sb_tail_i=zeros(half), audio_tail=zeros(half),
        spec_tail_l=zeros(half), spec_tail_r=zeros(half),
        agc_env=torch.full((channels,), 1e-6, device=device),
        nb_avg=zeros(), am_dc=zeros(2),
        sam=planar.sam_init_planar(channels, device),
        lms=lms.lms_nr_init(channels, device=device),
        nfloor=zeros(), conv_tail_r=zeros(half), conv_tail_i=zeros(half),
    )


_SSB_MODES = (DemodMode.USB, DemodMode.LSB, DemodMode.RTTY, DemodMode.CW,
              DemodMode.CW_NARROW)
LMS_MAX_CHANNELS = 128   # the JAX bank's LMS lane width (pallas_lms.LANES)


def check_ported(mode: DemodMode, conv_first: bool = False,
                 conv_inline_denoise: bool = False, fft_length: int = 256) -> None:
    """Raise NotImplementedError for a stage the port does not have yet."""
    if mode not in _SSB_MODES + (DemodMode.AM, DemodMode.SAM):
        raise ValueError(f"unsupported mode {mode}")
    if conv_first or conv_inline_denoise:
        raise NotImplementedError("the conv-first variants come with ROADMAP item 7")
    if fft_length != 256:
        raise NotImplementedError("the port frames 128-sample blocks; fft_length "
                                  "other than 256 is ROADMAP item 2's")


def _run_lms(audio, state: lms.LMSState, mu, mode: str):
    c = audio.shape[0]
    if c > LMS_MAX_CHANNELS:
        raise ValueError(f"rx_chain_batched LMS stages support <= {LMS_MAX_CHANNELS} "
                         f"channels (got {c}); shard the bank")
    return lms.lms_nr_run(audio, state, mu, mode)


def rx_chain_batched(params: ReceiverParams, state: ReceiverState, xr, xi, *,
                     mode: DemodMode, nr: NRMode, noise_blanker: bool,
                     quantize_output: bool, fft_length: int = 256,
                     sample_rate: float = 44117.64706, conv_first: bool = False,
                     conv_inline_denoise: bool = False):
    """One segment of the bank chain on (C, n) f32 planes, n a multiple of
    128; ``params.nco_inc`` holds the (C,) DDS increments. Stage for stage
    the JAX ``rx_chain_batched``: input gain and IQ balance, [noise blanker],
    DDS mix, band-pass + SSB demod, or band-pass + AM envelope or SAM PLL
    (at ``sample_rate``) + DC blocker,
    [LMS notch], AGC, PBT, [LMS denoise, x1.1 makeup, R <- L, or spectral
    subtraction with the split DFT], output gain (0 when muted), [q15 round
    trip]. Every product is full fp32, the JAX chain's default
    ``matmul_precision="highest"``; the port does not read that setting. Returns ({"audio_l", "audio_r"}, state')."""
    check_ported(mode, conv_first, conv_inline_denoise, fft_length)
    xr = xr * params.input_gain
    xi = xi * params.input_gain
    xr, xi = planar.iq_gain_balance_planar(xr, xi, params.iq_gain_balance)

    nb_avg = state.nb_avg
    if noise_blanker:
        xr, xi, nb_avg = planar.noise_blanker_planar(
            xr, xi, nb_avg, params.nb_threshold_db, params.nb_tau)

    xr, xi, nco_phase = planar.nco_mix_planar(xr, xi, state.nco_phase, params.nco_inc)

    am_dc, sam_state = state.am_dc, state.sam
    if mode in (DemodMode.AM, DemodMode.SAM):
        zr, zi, sb_tail_r, sb_tail_i = planar.overlap_save_filter_planar(
            xr, xi, params.w_sideband, state.sb_tail_r, state.sb_tail_i)
        if mode == DemodMode.AM:
            audio, am_dc = planar.demod_am_planar(zr, zi, am_dc)
        else:
            audio, sam_state = planar.demod_sam_planar(zr, zi, sam_state,
                                                       sample_rate=sample_rate)
    else:
        audio, sb_tail_r, sb_tail_i = planar.ssb_filter_demod_planar(
            xr, xi, params.w_ssb, state.sb_tail_r, state.sb_tail_i)

    lms_state = state.lms
    if nr.kind == "notch":
        audio, lms_state = _run_lms(audio, lms_state, params.lms_mu, "notch")

    agc_params = agc_ops.AGCParams(
        release=params.agc_release, target=params.agc_target,
        max_gain=params.agc_max_gain, enabled=params.agc_enabled)
    audio, agc_env = agc_ops.agc_run(audio, agc_params, state.agc_env)

    audio_l, audio_r, audio_tail = planar.pbt_filter_planar(
        audio, params.w_pbt, state.audio_tail)

    nfloor = state.nfloor
    spec_tail_l, spec_tail_r = state.spec_tail_l, state.spec_tail_r
    if nr.kind == "lms":
        audio_l, lms_state = _run_lms(audio_l, lms_state, params.lms_mu, "denoise")
        audio_l = audio_l * 1.1          # makeup gain (RDSP_convolutional.h:334)
        audio_r = audio_l                # mono copy R<-L (:335)
    elif nr.kind == "spectral":
        audio_l, audio_r, nfloor, spec_tail_l, spec_tail_r = planar.spectral_subtract_planar(
            audio_l, audio_r, params.nr_level, nfloor, params.dft_cos, params.dft_sin,
            spec_tail_l, spec_tail_r)

    out_gain = 0.0 if params.mute else params.output_gain
    audio_l = audio_l * out_gain
    audio_r = audio_r * out_gain
    if quantize_output:
        audio_l, audio_r = quantize_q15(audio_l), quantize_q15(audio_r)

    new_state = state._replace(
        nco_phase=nco_phase, sb_tail_r=sb_tail_r, sb_tail_i=sb_tail_i,
        audio_tail=audio_tail, agc_env=agc_env, nb_avg=nb_avg, am_dc=am_dc,
        sam=sam_state, lms=lms_state, nfloor=nfloor, spec_tail_l=spec_tail_l,
        spec_tail_r=spec_tail_r)
    return {"audio_l": audio_l, "audio_r": audio_r}, new_state


class ReceiverBank:
    """Many-channel receiver bank: shared mode and filters, a frequency per
    channel (``radiodsp_sdr_rx_tpu/models/receiver.py:576-642``).

    ``backend`` is "vmap" or "batched", as in the JAX package, where the two
    compute the same function (tests/test_batched_bank.py). Here both run the
    one bank chain, ``rx_chain_batched``, with the channels as a tensor axis
    in place of vmap, and both run the LMS stages on the K3 kernel on the
    card. ``device=None`` means the CUDA card and raises without one; pass
    ``device="cpu"`` to run the plain PyTorch versions.
    """

    def __init__(self, config: ReceiverConfig, freqs_hz, backend: str = "vmap",
                 device=None):
        if backend not in ("vmap", "batched"):
            raise ValueError(f"backend must be 'vmap' or 'batched', got {backend!r}")
        check_ported(config.mode, config.conv_first,
                     config.conv_inline_denoise, config.fft_length)
        self.backend = backend
        self.config = config
        self.device = resolve_device(device)
        self.n_channels = len(freqs_hz)
        self.params = params_from_numpy(build_params(config)._replace(
            nco_inc=nco.bank_phase_incs(config, freqs_hz))._asdict(), self.device)
        self.statics = dict(
            mode=config.mode, nr=config.nr, noise_blanker=config.noise_blanker,
            quantize_output=config.quantize_output, fft_length=config.fft_length,
            sample_rate=config.sample_rate, conv_first=config.conv_first,
            conv_inline_denoise=config.conv_inline_denoise)

    def init_state(self) -> ReceiverState:
        return init_state(self.config.fft_length, self.n_channels, self.device)

    def process_planar(self, xr, xi, state: ReceiverState):
        """One segment of planar f32 IQ, (C, n) each. Returns
        ({"audio_l", "audio_r"}, next state)."""
        xr = torch.as_tensor(xr, dtype=torch.float32, device=self.device)
        xi = torch.as_tensor(xi, dtype=torch.float32, device=self.device)
        return rx_chain_batched(self.params, state, xr, xi, **self.statics)

    def process(self, iq, state: ReceiverState):
        """Complex IQ at the host boundary: (C, n), or (n,) for every channel."""
        return self.process_planar(*split_iq(iq, self.n_channels), state)
