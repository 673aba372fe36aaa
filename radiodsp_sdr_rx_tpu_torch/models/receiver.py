"""Receiver parameters built on the host (``radiodsp_sdr_rx_tpu/models/receiver.py:59-167``).

``build_params`` designs every operator in float64 numpy, exactly as the JAX
package does, so the two packages compute from bit-equal operators. The
fields keep the JAX names; the fused SSB bank reads ``w_ssb``, ``w_pbt``, the
``agc_*`` fields, the gains and ``iq_gain_balance``. The DFT matrices and the
LMS step size are left ``None`` until the spectral and LMS noise-reduction
slices of ROADMAP.md port them.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

from radiodsp_sdr_rx_tpu_torch.models.config import ReceiverConfig
from radiodsp_sdr_rx_tpu_torch.ops import agc as agc_ops
from radiodsp_sdr_rx_tpu_torch.ops import fir_design, nco
from radiodsp_sdr_rx_tpu_torch.ops.operators import pbt_operator, ssb_demod_operator


class ReceiverParams(NamedTuple):
    """Pipeline parameters, field for field the JAX ``ReceiverParams``."""

    nco_inc: Any          # uint32 DDS increment
    w_sideband: Any       # (2F, F) f32 collapsed overlap-save operator
    w_ssb: Any            # (2F, F/2) f32 fused sideband filter + SSB demod
    w_pbt: Any            # (F, F) f32 PBT operator -> [L|R]
    w_audio: Any          # (2F, F) f32 audio operator
    dft_cos: Any          # None: spectral NR slice
    dft_sin: Any          # None: spectral NR slice
    agc_release: Any      # f32
    agc_target: Any       # f32
    agc_max_gain: Any     # f32
    agc_enabled: Any      # bool
    lms_mu: Any           # None: LMS NR slice
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
        dft_cos=None,
        dft_sin=None,
        agc_release=np.float32(agc_p.release),
        agc_target=np.float32(agc_p.target),
        agc_max_gain=np.float32(agc_p.max_gain),
        agc_enabled=np.bool_(agc_p.enabled),
        lms_mu=None,
        nr_level=np.float32(config.nr.level),
        nb_threshold_db=np.float32(config.nb_threshold_db),
        nb_tau=np.float32(config.nb_tau_samples),
        input_gain=np.float32(config.input_gain),
        output_gain=np.float32(config.output_gain),
        iq_gain_balance=np.float32(config.iq_gain_balance),
        mute=np.bool_(config.mute),
    )
