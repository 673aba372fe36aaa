"""Host-side design of the PyTorch port == the JAX package's, bit for bit.

Both packages design in float64 numpy with the same code, so every operator,
mask, phase increment and AGC preset must be np.array_equal (no tolerance).
"""

import numpy as np
import pytest

from radiodsp_sdr_rx_tpu.models import config as jcfg
from radiodsp_sdr_rx_tpu.models.receiver import build_params as jax_build_params
from radiodsp_sdr_rx_tpu.ops import agc as jagc
from radiodsp_sdr_rx_tpu.ops import fir_design as jfir
from radiodsp_sdr_rx_tpu.ops import nco as jnco
from radiodsp_sdr_rx_tpu.ops import windows as jwin
from radiodsp_sdr_rx_tpu_torch.models import config as tcfg
from radiodsp_sdr_rx_tpu_torch.models.receiver import build_params
from radiodsp_sdr_rx_tpu_torch.ops import agc as tagc
from radiodsp_sdr_rx_tpu_torch.ops import fir_design as tfir
from radiodsp_sdr_rx_tpu_torch.ops import nco as tnco
from radiodsp_sdr_rx_tpu_torch.ops import windows as twin

MODES = ["USB", "LSB", "CW", "CW_NARROW", "RTTY", "SAM"]
AGC_MODES = ["OFF", "FAST", "MEDIUM", "SLOW"]
FS = 44117.64706


def _configs(mode, agc, **kw):
    common = dict(vfo_freq=7_200_000.0, capture_center_freq=7_190_000.0, **kw)
    return (jcfg.ReceiverConfig(mode=jcfg.DemodMode[mode], agc=jcfg.AGCMode[agc], **common),
            tcfg.ReceiverConfig(mode=tcfg.DemodMode[mode], agc=tcfg.AGCMode[agc], **common))


@pytest.mark.parametrize("agc", AGC_MODES)
@pytest.mark.parametrize("mode", MODES)
def test_build_params_bit_equal(mode, agc):
    jc, tc = _configs(mode, agc)
    want, got = jax_build_params(jc), build_params(tc)
    assert got._fields == want._fields
    compared = 0
    for name in got._fields:
        g = getattr(got, name)
        w = np.asarray(getattr(want, name))
        assert np.asarray(g).dtype == w.dtype, name
        assert np.array_equal(np.asarray(g), w), name
        compared += 1
    assert compared == len(got._fields)


@pytest.mark.parametrize("vfo", [7_200_000.0, 14_070_000.0])
def test_config_properties_equal(vfo):
    for mode in MODES:
        jc, tc = _configs(mode, "MEDIUM", pbt_lo=200.0)
        jc, tc = jc.with_(vfo_freq=vfo), tc.with_(vfo_freq=vfo)
        assert (tc.iq_band, tc.nco_freq, tc.sideband, tc.tuning_offset) == \
            (jc.iq_band, jc.nco_freq, jc.sideband, jc.tuning_offset)


@pytest.mark.parametrize("window_id", [0, 1, 2, 3, 4])
def test_fir_window_and_masks_bit_equal(window_id):
    assert np.array_equal(twin.fir_window(window_id, 129), jwin.fir_window(window_id, 129))
    for lo, hi in [(300.0, 3000.0), (-2700.0, -300.0), (450.0, 950.0)]:
        mt = tfir.design_filter_mask(lo, hi, FS, window_id=window_id)
        mj = jfir.design_filter_mask(lo, hi, FS, window_id=window_id)
        assert np.array_equal(mt, mj)
        assert np.array_equal(tfir.overlap_save_matrix_real(mt),
                              jfir.overlap_save_matrix_real(mj))


def test_phase_increments_bit_equal():
    freqs = np.concatenate([np.linspace(-22_000.0, 22_000.0, 97), [0.0, 1000.0, -700.0]])
    for f in freqs:
        assert tnco.freq_to_phase_inc(f, FS) == jnco.freq_to_phase_inc(f, FS)


def test_agc_presets_equal():
    for target, max_gain in [(0.5, 316.0), (0.25, 100.0)]:
        assert tagc.agc_presets(FS, target, max_gain) == jagc.agc_presets(FS, target, max_gain)
    assert tagc.preset_from_release_time(1.3, FS) == jagc.preset_from_release_time(1.3, FS)
