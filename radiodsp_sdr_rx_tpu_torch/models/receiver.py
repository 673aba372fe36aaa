"""The receiver's parameters, state and reference bank chain (``radiodsp_sdr_rx_tpu/models/receiver.py``).

``build_params`` designs every operator in float64 numpy, exactly as the JAX
package does, so the two packages compute from bit-equal operators. The
fields keep the JAX names.

``rx_chain_batched`` (:310-460) is the reference chain on (C, n) planes,
plain PyTorch as the JAX chain is XLA, except the adaptive LMS stages, which
run the K3 kernel on the card (``ops/lms_bank.py``), and SAM's exact PLL
(``planar.demod_sam_planar``), which runs its kernel ``sam_exact`` there. It
covers every configuration the JAX chain takes: the SSB modes, AM and SAM,
NR off / notch / lms (DNR1-4) / spectral (SPEC1-4), the noise blanker, the
conv-first variants (the audio band-pass, or the inline spectral denoise, on
the mixed IQ before the demod, and no PBT), ``quantize_output``, ``mute``
and any ``fft_length``. ``ReceiverBank`` runs it for many channels.

``rx_chain`` (:141-307) is the per-channel chain of the JAX package, (n,)
planes and a state without the channel axis; it runs ``rx_chain_batched`` on
a (1, n) view. ``Receiver`` (:473-573) is the single-channel receiver the
CLI builds: the manual I/Q swap and the automatic I2S-slip repair
(``ops/preprocessor.py``), re-scored on every segment's first 2^15 samples
with hysteresis, in front of ``rx_chain``. On the card the slip is scored
there and one int per segment comes back to the host.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.models.config import DemodMode, NRMode, ReceiverConfig
from radiodsp_sdr_rx_tpu_torch.ops import agc as agc_ops
from radiodsp_sdr_rx_tpu_torch.ops import fir_design, lms, nco, planar, preprocessor
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
    """All carried DSP state, field for field the JAX ``ReceiverState``: a
    bank's with the leading channel axis of the JAX bank's stacked state, a
    ``Receiver``'s without it (the shapes below less the C). DDS words are
    int64 in [0, 2^32). F is fft_length."""

    nco_phase: torch.Tensor     # (C,) int64 DDS phase words
    sb_tail_r: torch.Tensor     # (C, F/2) f32 IQ-stage overlap-save carry (mixed)
    sb_tail_i: torch.Tensor     # (C, F/2)
    audio_tail: torch.Tensor    # (C, F/2) f32 PBT-stage carry
    spec_tail_l: torch.Tensor   # (C, F/2) f32 spectral-subtraction carries
    spec_tail_r: torch.Tensor
    agc_env: torch.Tensor       # (C,) f32
    nb_avg: torch.Tensor        # (C,) f32
    am_dc: torch.Tensor         # (C, 2) f32 DC-blocker carry
    sam: planar.SAMStatePlanar
    lms: lms.LMSState
    nfloor: torch.Tensor        # (C,) f32 spectral-subtraction noise floor
    conv_tail_r: torch.Tensor   # (C, F/2) f32 conv-first pre-demod carries (mixed)
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


def check_ported(mode: DemodMode) -> None:
    """Raise ValueError for a mode the chain has no demodulator for, as the
    JAX chain does."""
    if mode not in _SSB_MODES + (DemodMode.AM, DemodMode.SAM):
        raise ValueError(f"unsupported mode {mode}")


def _run_lms(audio, state: lms.LMSState, mu, mode: str, max_channels: int | None):
    c = audio.shape[0]
    if max_channels is not None and c > max_channels:
        raise ValueError(f"rx_chain_batched LMS stages support <= {max_channels} "
                         f"channels (got {c}); shard the bank")
    return lms.lms_nr_run(audio, state, mu, mode)


def rx_chain_batched(params: ReceiverParams, state: ReceiverState, xr, xi, *,
                     mode: DemodMode, nr: NRMode, noise_blanker: bool,
                     quantize_output: bool, fft_length: int = 256,
                     sample_rate: float = 44117.64706, conv_first: bool = False,
                     conv_inline_denoise: bool = False,
                     max_lms_channels: int | None = LMS_MAX_CHANNELS):
    """One segment of the bank chain on (C, n) f32 planes, n a multiple of
    fft_length / 2; ``params.nco_inc`` holds the (C,) DDS increments. Stage
    for stage the JAX ``rx_chain_batched``: input gain and IQ balance,
    [noise blanker], DDS mix, [conv-first: the audio band-pass (``w_audio``),
    or with ``conv_inline_denoise`` the inline spectral denoise, on the
    mixed IQ], band-pass + SSB demod, or band-pass + AM envelope or SAM PLL
    (at ``sample_rate``) + DC blocker, [LMS notch], AGC, PBT (conv-first:
    none, L = R = the AGC's output, the PBT tail carried unchanged), [LMS
    denoise, x1.1 makeup, R <- L, or spectral subtraction with the split
    DFT], output gain (0 when muted), [q15 round trip]. Every product is
    full fp32, the JAX chain's default ``matmul_precision="highest"``; the
    port does not read that setting. The LMS stages raise ValueError above
    ``max_lms_channels`` channels, the JAX chain's 128 lanes; ``None``
    lifts the cap, as the JAX vmap bank has none (K3 takes any C). Returns ({"audio_l", "audio_r"},
    state')."""
    check_ported(mode)
    xr = xr * params.input_gain
    xi = xi * params.input_gain
    xr, xi = planar.iq_gain_balance_planar(xr, xi, params.iq_gain_balance)

    nb_avg = state.nb_avg
    if noise_blanker:
        xr, xi, nb_avg = planar.noise_blanker_planar(
            xr, xi, nb_avg, params.nb_threshold_db, params.nb_tau)

    xr, xi, nco_phase = planar.nco_mix_planar(xr, xi, state.nco_phase, params.nco_inc)

    conv_tail_r, conv_tail_i = state.conv_tail_r, state.conv_tail_i
    if conv_first:
        if conv_inline_denoise:
            xr, xi, conv_tail_r, conv_tail_i = planar.inline_denoise_planar(
                xr, xi, params.dft_cos, params.dft_sin, conv_tail_r, conv_tail_i)
        else:
            xr, xi, conv_tail_r, conv_tail_i = planar.overlap_save_filter_planar(
                xr, xi, params.w_audio, conv_tail_r, conv_tail_i)

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
        audio, lms_state = _run_lms(audio, lms_state, params.lms_mu, "notch", max_lms_channels)

    agc_params = agc_ops.AGCParams(
        release=params.agc_release, target=params.agc_target,
        max_gain=params.agc_max_gain, enabled=params.agc_enabled)
    audio, agc_env = agc_ops.agc_run(audio, agc_params, state.agc_env)

    if conv_first:
        audio_l, audio_r, audio_tail = audio, audio, state.audio_tail
    else:
        audio_l, audio_r, audio_tail = planar.pbt_filter_planar(
            audio, params.w_pbt, state.audio_tail)

    nfloor = state.nfloor
    spec_tail_l, spec_tail_r = state.spec_tail_l, state.spec_tail_r
    if nr.kind == "lms":
        audio_l, lms_state = _run_lms(audio_l, lms_state, params.lms_mu, "denoise",
                                     max_lms_channels)
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
        spec_tail_r=spec_tail_r, conv_tail_r=conv_tail_r, conv_tail_i=conv_tail_i)
    return {"audio_l": audio_l, "audio_r": audio_r}, new_state


def _map_state(fn, state):
    """``fn`` on every tensor of a (nested) state."""
    return type(state)(*(_map_state(fn, v) if isinstance(v, tuple) else fn(v) for v in state))


def rx_chain(params: ReceiverParams, state: ReceiverState, xr, xi, **statics):
    """One segment of one channel: xr, xi (n,) f32, ``state`` without the
    channel axis (``Receiver.init_state``), ``params.nco_inc`` one DDS word.
    The keywords are ``rx_chain_batched``'s. Returns ({"audio_l",
    "audio_r"} each (n,), state')."""
    inc = torch.as_tensor(params.nco_inc, dtype=torch.int64, device=xr.device).reshape(1)
    out, state = rx_chain_batched(params._replace(nco_inc=inc),
                                  _map_state(lambda t: t[None], state),
                                  xr[None], xi[None], max_lms_channels=None, **statics)
    return ({k: v[0] for k, v in out.items()},
            _map_state(lambda t: t[0], state))


def _split_planar(iq, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex IQ at the host boundary -> f32 planes on ``device``; a real
    input is the I plane with a zero Q plane."""
    if not torch.is_tensor(iq):
        iq = torch.from_numpy(np.ascontiguousarray(iq))
    iq = iq.to(device)
    if iq.is_complex():
        return iq.real.float().contiguous(), iq.imag.float().contiguous()
    return iq.float(), torch.zeros_like(iq, dtype=torch.float32)


def _statics(config: ReceiverConfig) -> dict:
    return dict(mode=config.mode, nr=config.nr, noise_blanker=config.noise_blanker,
                quantize_output=config.quantize_output, fft_length=config.fft_length,
                sample_rate=config.sample_rate, conv_first=config.conv_first,
                conv_inline_denoise=config.conv_inline_denoise)


class Receiver:
    """Single-channel receiver (``radiodsp_sdr_rx_tpu/models/receiver.py:473-573``).

    >>> rx = Receiver(ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_200_000,
    ...                              capture_center_freq=7_190_000), device="cpu")
    >>> state = rx.init_state()
    >>> out, state = rx.process(iq_segment, state)      # complex at the boundary
    >>> out, state = rx.process_planar(xr, xi, state)   # planar f32

    ``device=None`` means the CUDA card and raises without one; pass
    ``device="cpu"`` for the plain PyTorch versions. With ``swap_iq`` the
    planes swap first. With ``auto_iq_repair`` every segment's first
    ``_REPAIR_SCORE_SAMPLES`` samples are scored for a one-sample I2S slip
    (``preprocessor.detect_iq_error_host``: identity, delay I, delay Q);
    the first segment's verdict is adopted, a later different one only after
    ``iq_repair_hysteresis`` consecutive segments agree on it; the locked
    repair is applied with the previous raw segment's last sample carried in.
    """

    _REPAIR_SCORE_SAMPLES = 1 << 15   # detector prefix bound per segment

    def __init__(self, config: ReceiverConfig, device=None):
        check_ported(config.mode)
        self.config = config
        self.device = resolve_device(device)
        self._host_params = build_params(config)
        self.params = self._to_device(self._host_params)
        self.statics = _statics(config)
        self._repair_idx: int | None = None
        self._repair_carry = None
        self._repair_candidate: int | None = None
        self._repair_votes = 0

    def _to_device(self, host: ReceiverParams, reuse: ReceiverParams | None = None):
        """Parameters on the device, nco_inc a (1,) int64 tensor. With
        ``reuse`` (the host parameters this receiver was built from), the
        fields whose values did not change keep this receiver's tensors."""
        fields = host._replace(nco_inc=np.asarray([host.nco_inc], np.int64))._asdict()
        same = set() if reuse is None else {
            name for name in ReceiverParams._fields
            if np.array_equal(np.asarray(getattr(host, name)), np.asarray(getattr(reuse, name)))}
        params = params_from_numpy({k: v for k, v in fields.items() if k not in same},
                                   self.device)
        return params._replace(**{name: getattr(self.params, name) for name in same})

    def _maybe_repair(self, xr, xi):
        if self.config.swap_iq:          # manual swap (ino:118, swapIQ)
            xr, xi = xi, xr
        if not self.config.auto_iq_repair:
            return xr, xi
        m = self._REPAIR_SCORE_SAMPLES
        idx = preprocessor.detect_iq_error_host(xr[..., :m], xi[..., :m])
        if self._repair_idx is None:
            self._repair_idx = idx           # first segment: adopt directly
        elif idx != self._repair_idx:
            if idx == self._repair_candidate:
                self._repair_votes += 1
            else:
                self._repair_candidate, self._repair_votes = idx, 1
            if self._repair_votes >= self.config.iq_repair_hysteresis:
                self._repair_idx = idx       # k consecutive segments agree
                self._repair_candidate, self._repair_votes = None, 0
        else:
            self._repair_candidate, self._repair_votes = None, 0
        xr, xi, self._repair_carry = preprocessor.apply_repair_planar_host(
            xr, xi, self._repair_idx, self._repair_carry)
        return xr, xi

    @property
    def iq_repair_idx(self) -> int | None:
        """Locked I2S repair (0 identity, 1 swap, 2 delay I, 3 delay Q);
        None until the first segment is processed."""
        return self._repair_idx

    def init_state(self) -> ReceiverState:
        return _map_state(lambda t: t[0], init_state(self.config.fft_length, 1, self.device))

    def retune(self, **updates) -> "Receiver":
        """A receiver of the updated config. When mode, NR, blanker, q15,
        fft_length and sample rate are unchanged it keeps this receiver's
        chain settings (as the JAX receiver keeps its compiled pipeline),
        shares the parameter tensors whose values did not change, and keeps
        the locked I2S repair and its carry; else it is a new Receiver."""
        new_config = self.config.with_(**updates)
        old = self.config
        if not all(getattr(new_config, k) == getattr(old, k) for k in (
                "mode", "nr", "noise_blanker", "quantize_output", "fft_length",
                "sample_rate")):
            return Receiver(new_config, self.device)
        return self.retuned(new_config)

    def retuned(self, new_config: ReceiverConfig) -> "Receiver":
        """A receiver of ``new_config``, whose chain settings the caller has
        found equal to this one's: it shares this receiver's chain settings
        and the parameter tensors whose values did not change, and keeps the
        locked I2S repair and its carry (``retune``; ``models/appliance``)."""
        new_rx = object.__new__(Receiver)
        new_rx.config, new_rx.device, new_rx.statics = new_config, self.device, self.statics
        new_rx._host_params = build_params(new_config)
        new_rx.params = self._to_device(new_rx._host_params, reuse=self._host_params)
        new_rx._repair_idx = self._repair_idx       # locked repair survives
        new_rx._repair_carry = self._repair_carry
        new_rx._repair_candidate, new_rx._repair_votes = None, 0
        return new_rx

    def process(self, iq, state: ReceiverState):
        """One segment of complex IQ (n,). Returns ({"audio_l", "audio_r"},
        state')."""
        return self.process_planar(*_split_planar(iq, self.device), state)

    def process_planar(self, xr, xi, state: ReceiverState):
        """One segment of planar f32 IQ, (n,) each."""
        xr = torch.as_tensor(xr, dtype=torch.float32, device=self.device)
        xi = torch.as_tensor(xi, dtype=torch.float32, device=self.device)
        xr, xi = self._maybe_repair(xr, xi)
        return rx_chain(self.params, state, xr, xi, **self.statics)


class ReceiverBank:
    """Many-channel receiver bank: shared mode and filters, a frequency per
    channel (``radiodsp_sdr_rx_tpu/models/receiver.py:576-642``).

    ``backend`` is "vmap" or "batched", as in the JAX package, where the two
    compute the same function (tests/test_batched_bank.py). Here both run the
    one bank chain, ``rx_chain_batched``, with the channels as a tensor axis
    in place of vmap, and both run the LMS stages on the K3 kernel on the
    card. As in JAX, "batched" takes at most 128 channels with an LMS stage
    (ValueError above) and "vmap" any number. The JAX vmap bank keeps the
    LMS ``first`` flag per channel; the port runs the stage with
    ``all(first)``, which agrees whenever every channel starts together
    (``init_state`` and every segment after it). ``device=None`` means the CUDA card and raises without one; pass
    ``device="cpu"`` to run the plain PyTorch versions.
    """

    def __init__(self, config: ReceiverConfig, freqs_hz, backend: str = "vmap",
                 device=None):
        if backend not in ("vmap", "batched"):
            raise ValueError(f"backend must be 'vmap' or 'batched', got {backend!r}")
        check_ported(config.mode)
        self.backend = backend
        self.config = config
        self.device = resolve_device(device)
        self.n_channels = len(freqs_hz)
        self.params = params_from_numpy(build_params(config)._replace(
            nco_inc=nco.bank_phase_incs(config, freqs_hz))._asdict(), self.device)
        self.statics = _statics(config)

    def init_state(self) -> ReceiverState:
        return init_state(self.config.fft_length, self.n_channels, self.device)

    def process_planar(self, xr, xi, state: ReceiverState):
        """One segment of planar f32 IQ, (C, n) each. Returns
        ({"audio_l", "audio_r"}, next state)."""
        xr = torch.as_tensor(xr, dtype=torch.float32, device=self.device)
        xi = torch.as_tensor(xi, dtype=torch.float32, device=self.device)
        cap = None if self.backend == "vmap" else LMS_MAX_CHANNELS
        return rx_chain_batched(self.params, state, xr, xi, max_lms_channels=cap,
                                **self.statics)

    def process(self, iq, state: ReceiverState):
        """Complex IQ at the host boundary: (C, n), or (n,) for every channel."""
        return self.process_planar(*split_iq(iq, self.n_channels), state)
