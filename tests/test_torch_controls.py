"""The port's control plane (``models/controls.py``, ``models/vfo.py``) against
the JAX package's: pure host code, so held exactly.

The same seeded sequence of several hundred events (encoder detents, the
three buttons, PBT edges) goes through the JAX ``ControlPlane`` and the
port's, from several starting configurations; after every event the config
fields, the VFO's frequency, step and step ceiling, the menu mode and level
and the scope are equal. Also the VFO's clamps at 30 kHz and 30 MHz, the
auto step-down near range edges, the LO clock with and without the
crystal correction, and the constants and cycle orders.
"""

import dataclasses

import numpy as np
import pytest

from radiodsp_sdr_rx_tpu.models import config as jcfg
from radiodsp_sdr_rx_tpu.models import controls as jcontrols
from radiodsp_sdr_rx_tpu.models import vfo as jvfo
from radiodsp_sdr_rx_tpu_torch.models import config as tcfg
from radiodsp_sdr_rx_tpu_torch.models import controls, vfo

EVENTS = 600

STARTS = {
    "default": {},
    "usb_20m": dict(mode="USB", vfo_freq=14_200_000.0, capture_center_freq=14_190_000.0),
    "am_mw": dict(mode="AM", vfo_freq=1_500_000.0, capture_center_freq=1_500_000.0),
    "lsb_lf": dict(mode="LSB", vfo_freq=95_000.0, capture_center_freq=95_000.0),
    "cw_top": dict(mode="CW", vfo_freq=29_990_000.0, capture_center_freq=29_990_000.0),
}


def _configs(mode=None, **kw):
    """(JAX config, port config) of the same settings."""
    if mode is None:
        return jcfg.ReceiverConfig(**kw), tcfg.ReceiverConfig(**kw)
    return (jcfg.ReceiverConfig(mode=jcfg.DemodMode[mode], **kw),
            tcfg.ReceiverConfig(mode=tcfg.DemodMode[mode], **kw))


def _plain(v):
    """An enum by its name and value; anything else as it is."""
    return (type(v).__name__, v.name, v.value) if hasattr(v, "name") else v


def assert_planes_equal(port, ref, where=""):
    for f in dataclasses.fields(ref.config):
        got, want = getattr(port.config, f.name), getattr(ref.config, f.name)
        assert _plain(got) == _plain(want), (where, f.name, got, want)
    assert _plain(port.config.effective_audio_filter) == _plain(ref.config.effective_audio_filter)
    assert (port.vfo.freq, port.vfo.step_index, port.vfo.max_step_index, port.vfo.step) == (
        ref.vfo.freq, ref.vfo.step_index, ref.vfo.max_step_index, ref.vfo.step), where
    assert (port.menu_mode, port.menu_level, port.scope) == (
        ref.menu_mode, ref.menu_level, ref.scope), where


def _event(rng):
    """One random UI event: a method name and its arguments."""
    kind = rng.choice(["encoder", "encoder", "encoder", "menu", "a", "b", "b", "pbt"])
    if kind == "encoder":
        return "encoder", (int(rng.choice([-1, 1]) * rng.integers(1, 40)),)
    if kind == "pbt":
        return "pbt_adjust", (str(rng.choice(["lo", "hi"])), int(rng.choice([-1, 1])))
    return {"menu": "button_menu", "a": "button_a", "b": "button_b"}[kind], ()


@pytest.mark.parametrize("start", sorted(STARTS))
def test_event_sequence_matches_jax(start):
    jc, tc = _configs(**STARTS[start])
    ref, port = jcontrols.ControlPlane(config=jc), controls.ControlPlane(config=tc)
    assert_planes_equal(port, ref, "start")
    rng = np.random.default_rng(sorted(STARTS).index(start))
    seen = set()
    for k in range(EVENTS):
        name, args = _event(rng)
        getattr(ref, name)(*args)
        getattr(port, name)(*args)
        assert_planes_equal(port, ref, f"event {k} {name}{args}")
        seen.add((port.menu_level, port.config.mode.name, port.config.nr.name))
    # the walk reached every menu level and changed the mode and the NR
    assert {lvl for lvl, _, _ in seen} == {1, 2, 3, 4}
    assert len({m for _, m, _ in seen}) > 1 and len({nr for _, _, nr in seen}) > 1


@pytest.mark.parametrize("freq, step_index, detents, want", [
    (29_990_000, 6, +5, 30_000_000),     # clamped at TOP_FREQ
    (40_000, 4, -5, 30_000),             # clamped at BOTTOM_FREQ
    (30_000, 0, -1, 30_000),
    (7_050_000, 3, +2, 7_052_000),
])
def test_vfo_clamps_match_jax(freq, step_index, detents, want):
    ref, port = jvfo.VFO(freq=freq, step_index=step_index), vfo.VFO(freq=freq,
                                                                    step_index=step_index)
    assert port.tune(detents) == ref.tune(detents) == want
    assert (port.step_index, port.max_step_index) == (ref.step_index, ref.max_step_index)


@pytest.mark.parametrize("freq, step_index, detents", [
    (2_500_000, 6, -1),     # 1 MHz step lands in 1-2 MHz: down to 100 kHz
    (250_000, 5, -1),       # 100 kHz step in 100-200 kHz: down to 10 kHz
    (25_000_000, 4, 0),
    (90_000, 3, 0),         # below 99,999 Hz: the ceiling is 10 kHz
    (500_000, 6, 0),        # below 999,999 Hz: 100 kHz
    (120_000, 5, -3),
])
def test_vfo_auto_step_down_matches_jax(freq, step_index, detents):
    ref, port = jvfo.VFO(freq=freq, step_index=step_index), vfo.VFO(freq=freq,
                                                                    step_index=step_index)
    ref.tune(detents)
    port.tune(detents)
    assert (port.freq, port.step_index, port.max_step_index, port.step) == (
        ref.freq, ref.step_index, ref.max_step_index, ref.step)
    for _ in range(9):   # the step cycle wraps to MIN_TS under the ceiling
        ref.cycle_step()
        port.cycle_step()
        assert (port.step_index, port.step) == (ref.step_index, ref.step)


@pytest.mark.parametrize("offset", [0.0, -11_025.0, 700.0])
@pytest.mark.parametrize("corrected", [True, False])
def test_lo_clock_matches_jax(offset, corrected):
    ref, port = jvfo.VFO(freq=7_050_000), vfo.VFO(freq=7_050_000)
    assert port.lo_clock_hz(offset, corrected) == ref.lo_clock_hz(offset, corrected)
    assert port.lo_clock_hz(offset, corrected) == pytest.approx(
        4.0 * (7_050_000 - offset) * (1.0 if corrected else 1.0 + 33_000e-9), rel=1e-15)


def test_constants_and_cycles_match_jax():
    assert vfo.TUNING_STEPS == jvfo.TUNING_STEPS
    assert (vfo.MIN_TS, vfo.SI5351_CORRECTION_PPB) == (jvfo.MIN_TS, jvfo.SI5351_CORRECTION_PPB)
    assert controls.PBT_STEP_HZ == jcontrols.PBT_STEP_HZ
    assert (controls.L1_MODE_TS, controls.L2_FLT_NR, controls.L3_SCOPE_AGC,
            controls.L4_PBT_LH) == (jcontrols.L1_MODE_TS, jcontrols.L2_FLT_NR,
                                     jcontrols.L3_SCOPE_AGC, jcontrols.L4_PBT_LH)
    for name in ("_MODE_CYCLE", "_FILTER_CYCLE", "_AGC_CYCLE", "_NR_CYCLE"):
        assert [_plain(v) for v in getattr(controls, name)] == [
            _plain(v) for v in getattr(jcontrols, name)], name
