"""The port's ``Receiver`` on the CPU against the committed golden fixtures
(tests/goldens/*.npz), the oracles independent of the JAX code.

The six scenes are rebuilt by the port's own ``utils/scenes.py``, which
gives the JAX package's scene arrays bit for bit (checked here), with the
configurations of ``tools/make_goldens.build_cases`` (``scenes.golden_cases``,
checked field for field). Each case is held to its fixture as
tests/test_golden_captures.py holds the JAX receiver: the audio's first
32,768 samples within 1e-4 x the golden's peak, and the same quality floors
(aligned SNR, keying-envelope correlation, heterodyne rejection against NR
off, the segmental gain of NR on voiced speech, the blanker's cut of the
crest factor), measured by make_goldens' own metric functions.
"""

import dataclasses
import functools
import os
import sys

import numpy as np
import pytest

from radiodsp_sdr_rx_tpu.utils import scenes as jax_scenes
from radiodsp_sdr_rx_tpu_torch.models.config import NRMode
from radiodsp_sdr_rx_tpu_torch.models.receiver import Receiver
from radiodsp_sdr_rx_tpu_torch.utils import scenes

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
from make_goldens import build_cases  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
NAMES = ["ssb40m_s2", "cw20m_c1", "qrm_usb_spec2", "qrm_usb_notch", "voiced_usb_spec2",
         "fading_usb_nb"]


@functools.lru_cache(maxsize=None)
def _cases():
    jax_cases = {name: (cfg, iq, fn) for name, cfg, iq, fn in build_cases()}
    return {name: (cfg, iq, jax_cases[name]) for name, cfg, iq, _ in scenes.golden_cases()}


def _run(name, **updates):
    cfg, iq, (_, _, metrics_fn) = _cases()[name]
    rx = Receiver(cfg.with_(**updates), device="cpu")
    out, _ = rx.process(iq, rx.init_state())
    audio = out["audio_l"].numpy()
    return audio, metrics_fn(audio), np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))


def _assert_regression(audio, golden):
    want = golden["audio_l"]
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(audio[:len(want)], want, atol=1e-4 * scale, rtol=0)


def _equal_tree(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal_tree(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_tree(x, y)
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("fn", ["band_scene_40m_ssb", "band_scene_20m_cw", "qrm_ssb_scene",
                                "voiced_qrm_scene", "fading_ssb_scene"])
def test_scenes_equal_jax_bit_for_bit(fn):
    got, want = getattr(scenes, fn)(1 << 16), getattr(jax_scenes, fn)(1 << 16)
    assert got[0].dtype == np.complex64
    _equal_tree(got, want)


def test_golden_configs_match_make_goldens():
    for name in NAMES:
        cfg, _, (jcfg, _, _) = _cases()[name]
        for field in dataclasses.fields(jcfg):
            got, want = getattr(cfg, field.name), getattr(jcfg, field.name)
            if hasattr(want, "name"):
                got, want = got.name, want.name
            assert got == want, (name, field.name)


def test_golden_ssb40m():
    audio, metrics, golden = _run("ssb40m_s2")
    _assert_regression(audio, golden)
    assert metrics["snr_db"] >= float(golden["snr_db"]) - 1.0, metrics
    assert metrics["snr_db"] >= 25.0, metrics


def test_golden_cw20m():
    audio, metrics, golden = _run("cw20m_c1")
    _assert_regression(audio, golden)
    assert metrics["env_corr"] >= float(golden["env_corr"]) - 0.03, metrics
    assert metrics["env_corr"] >= 0.8, metrics


def test_golden_qrm_spec2():
    audio, metrics, golden = _run("qrm_usb_spec2")
    _assert_regression(audio, golden)
    assert metrics["snr_db"] >= float(golden["snr_db"]) - 1.0, metrics
    assert metrics["snr_db"] >= -8.0, metrics


def test_golden_qrm_notch():
    audio, metrics, golden = _run("qrm_usb_notch")
    _assert_regression(audio, golden)
    assert metrics["snr_db"] >= float(golden["snr_db"]) - 1.0, metrics
    assert metrics["het_db"] <= float(golden["het_db"]) + 3.0, metrics
    assert metrics["het_db"] <= 10.0, metrics
    _, metrics_off, _ = _run("qrm_usb_notch", nr=NRMode.OFF)
    assert metrics["het_db"] <= metrics_off["het_db"] - 15.0, (metrics, metrics_off)


def test_golden_voiced_spec2_nr_improves():
    audio, metrics, golden = _run("voiced_usb_spec2")
    _assert_regression(audio, golden)
    assert metrics["seg_db"] >= float(golden["seg_db"]) - 0.5, metrics
    assert metrics["snr_db"] >= float(golden["snr_db"]) - 1.0, metrics
    _, metrics_off, _ = _run("voiced_usb_spec2", nr=NRMode.OFF)
    assert metrics["seg_db"] >= metrics_off["seg_db"] + 0.5, (metrics, metrics_off)
    supp = 20.0 * np.log10(metrics_off["pause_rms"] / metrics["pause_rms"])
    assert supp >= 4.0, (supp, metrics, metrics_off)
    assert metrics["snr_db"] >= 4.0, metrics


def test_golden_fading_nb():
    audio, metrics, golden = _run("fading_usb_nb")
    _assert_regression(audio, golden)
    assert metrics["env_corr"] >= float(golden["env_corr"]) - 0.03, metrics
    assert metrics["env_corr"] >= 0.85, metrics
    a_off, _, _ = _run("fading_usb_nb", noise_blanker=False)

    def crest(a):
        m = np.abs(a[4000:])
        return float(np.max(m) / (np.median(m) + 1e-9))

    assert crest(audio) < 0.6 * crest(a_off), (crest(audio), crest(a_off))
