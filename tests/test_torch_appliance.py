"""The port's ``Appliance`` (``models/appliance.py``) on the CPU against the
JAX package's.

The same seeded 4,096-sample blocks and the same scripted UI events go
through both appliances: tuning and the step cycle, the AGC cycle, the
scope toggle and PBT at menu level 4; the mode cycle (SAM on two blocks
only); the filter and NR cycles (NOTCH and DNR1-4 run an LMS stage). After
every block the control planes are equal, ``reconfigured`` is equal, the
audio agrees within ATOL (1e-4; LMS_ATOL, 2e-4, while an LMS stage runs:
the ``Receiver`` parity bounds of ``tests/receiver_jax_compare.py``) and the
rendered frames are equal.

Also: a parameter-only swap keeps the receiver's chain settings and shares
every parameter tensor whose value did not change (the port's counterpart of
JAX's ``_fn is fn_before``); a static change builds a new receiver; both
carry the locked I2S repair. A JAX appliance whose receiver was swapped for
a parameter change has no repair votes until a segment's verdict agrees
with the locked repair, and raises AttributeError if the first segment
after the swap disagrees; the port's counts the vote.
"""

import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu.models.appliance import Appliance as JaxAppliance
from radiodsp_sdr_rx_tpu.utils import siggen
from radiodsp_sdr_rx_tpu_torch.models.appliance import Appliance
from radiodsp_sdr_rx_tpu_torch.models.receiver import Receiver, ReceiverParams

from receiver_jax_compare import ATOL, FS, LMS_ATOL, OFFSET, configs

BLOCK = 4096
TO_L2 = [("menu",), ("encoder", +1), ("menu",)]          # from level 1
TO_L3 = [("menu",), ("encoder", +1), ("encoder", +1), ("menu",)]
TO_L4 = [("menu",), ("encoder", +3), ("menu",)]

SCRIPTS = {
    # tune, the step cycle, AGC cycle, the scope toggle, PBT at level 4
    "tune_agc_scope_pbt": ("USB", [
        [], [("encoder", +2)], [("b",)], [("encoder", -3)], [("b",), ("b",), ("encoder", +1)],
        TO_L3 + [("b",)], [("b",)], [("a",)], [],
        [("menu",), ("encoder", +1), ("menu",), ("pbt", "lo"), ("encoder", +2)],
        [("pbt", "hi"), ("encoder", -3)], [("menu",), ("encoder", -3), ("menu",)],
        [("encoder", +1)]]),
    # USB -> LSB -> AM -> SAM (two blocks) -> RTTY -> CW_NARROW -> CW -> USB
    "mode_cycle": ("USB", [
        [], [("a",)], [("a",)], [("a",)], [], [("a",)], [("a",)], [("a",)], [("a",)]]),
    # the filter cycle, then NR off -> NOTCH -> DNR1..4 -> off, at level 2
    "filter_nr_cycle": ("USB", [
        [], TO_L2 + [("a",)], [("a",)], [("b",)], [("b",)], [("b",)], [("b",)], [("b",)],
        [("b",)], [("a",), ("a",), ("a",)]]),
}


def _blocks(n_blocks, seed):
    """Complex64 blocks: a USB voice OFFSET Hz above the centre, an AM
    carrier 3 kHz below it, weak noise."""
    n = n_blocks * BLOCK
    t = np.arange(n) / FS
    voice = siggen.ssb_from_audio(siggen.voice_like(n, FS, seed=seed), OFFSET, FS, "usb",
                                  amp=0.3)
    am = 0.1 * (1 + 0.5 * np.sin(2 * np.pi * 400.0 * t)) * np.exp(2j * np.pi * -3000.0 * t)
    iq = (voice + am + siggen.noise(n, 0.005, seed)).astype(np.complex64)
    return [iq[k * BLOCK:(k + 1) * BLOCK] for k in range(n_blocks)]


def assert_same_plane(port, ref):
    pc, rc = port.plane.config, ref.plane.config
    for name in ("mode", "nr", "agc", "audio_filter"):
        g, w = getattr(pc, name), getattr(rc, name)
        assert (g is None and w is None) or g.name == w.name, name
    assert (pc.vfo_freq, pc.pbt_lo, pc.pbt_hi) == (rc.vfo_freq, rc.pbt_lo, rc.pbt_hi)
    assert (port.plane.vfo.freq, port.plane.vfo.step, port.plane.menu_mode,
            port.plane.menu_level, port.plane.scope) == (
        ref.plane.vfo.freq, ref.plane.vfo.step, ref.plane.menu_mode, ref.plane.menu_level,
        ref.plane.scope)


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_scripted_session_matches_jax(script):
    mode, events = SCRIPTS[script]
    # the slip detector off: on this scene its verdict varies between
    # blocks, which the reference's swapped receiver cannot take (see below)
    jc, tc = configs(mode)
    ref, port = JaxAppliance(jc, block=BLOCK), Appliance(tc, block=BLOCK, device="cpu")
    sam_blocks = 0
    for k, (evs, iq) in enumerate(zip(events, _blocks(len(events), len(script)))):
        want, got = ref.step(iq, events=evs), port.step(iq, events=evs)
        assert_same_plane(port, ref)
        assert got["reconfigured"] == want["reconfigured"], k
        lms = port.plane.config.nr.kind in ("notch", "lms")
        sam_blocks += port.plane.config.mode.name == "SAM"
        for key in ("audio_l", "audio_r"):
            assert got[key].device.type == "cpu"
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       atol=LMS_ATOL if lms else ATOL, rtol=0,
                                       err_msg=f"block {k} {key}")
        assert port.render_frame() == ref.render_frame(), f"block {k}"
    assert sam_blocks <= 2
    assert port.blocks_processed == ref.blocks_processed == len(events)


def test_parameter_swap_shares_statics_and_unchanged_tensors():
    _, tc = configs("USB", agc="MEDIUM")
    app = Appliance(tc, block=BLOCK, metrics=False, device="cpu")
    iq = _blocks(2, 3)
    app.step(iq[0])
    old = app.receiver
    assert app.apply_events(TO_L3 + [("b",)])                  # AGC MEDIUM -> SLOW
    new = app.receiver
    assert new is not old and new.config.agc.name == "SLOW"
    assert new.statics is old.statics and new.device == old.device
    for name in ReceiverParams._fields:
        same = np.array_equal(np.asarray(getattr(new._host_params, name)),
                              np.asarray(getattr(old._host_params, name)))
        if same and torch.is_tensor(getattr(old.params, name)):
            assert getattr(new.params, name) is getattr(old.params, name), name
    assert new.params.w_sideband is old.params.w_sideband
    assert new.params.agc_release != old.params.agc_release
    # a tune shares the operators and makes a new DDS increment
    app.apply_events([("menu",), ("encoder", -2), ("menu",), ("encoder", +1)])
    tuned = app.receiver
    assert tuned.params.w_pbt is old.params.w_pbt
    assert not torch.equal(tuned.params.nco_inc, old.params.nco_inc)
    out = app.step(iq[1])
    assert np.isfinite(out["audio_l"].numpy()).all()


def test_static_swap_builds_a_receiver_and_carries_the_repair():
    _, tc = configs("USB", auto_iq_repair=True)
    app = Appliance(tc, block=BLOCK, metrics=False, device="cpu")
    app.step(_blocks(1, 4)[0])
    old = app.receiver
    assert old.iq_repair_idx == 0
    app.apply_events(TO_L2 + [("b",)])                         # NR off -> NOTCH
    new = app.receiver
    assert isinstance(new, Receiver) and new.statics is not old.statics
    assert new.statics["nr"].name == "NOTCH"
    assert (new._repair_idx, new._repair_carry) == (old._repair_idx, old._repair_carry)
    assert (new._repair_candidate, new._repair_votes) == (None, 0)


def _slipped(n, seed):
    """A USB voice OFFSET Hz above the centre, its I one sample late (a
    slipped I2S link: the detector's verdict is 3, delay Q to repair)."""
    iq = siggen.ssb_from_audio(siggen.voice_like(n, FS, seed=seed), OFFSET, FS, "usb",
                               amp=0.4) + siggen.noise(n, 0.01, seed)
    re = np.concatenate([iq.real[:1], iq.real[:-1]])
    return (re + 1j * iq.imag).astype(np.complex64)


def test_retuned_appliance_survives_a_differing_detection():
    jc, tc = configs("USB", auto_iq_repair=True)
    clean = _blocks(1, 5)[0]
    slipped = [_slipped(BLOCK, s) for s in range(3)]
    ref, port = JaxAppliance(jc, block=BLOCK, metrics=False), Appliance(
        tc, block=BLOCK, metrics=False, device="cpu")
    tune = [("encoder", +1)]                                    # a parameter-only swap
    ref.step(clean)
    port.step(clean)
    assert ref.receiver.iq_repair_idx == port.receiver.iq_repair_idx == 0
    with pytest.raises(AttributeError):                         # the reference's quirk
        ref.step(slipped[0], events=tune)
    port.step(slipped[0], events=tune)
    assert port.receiver.iq_repair_idx == 0
    assert (port.receiver._repair_candidate, port.receiver._repair_votes) == (3, 1)
    port.step(slipped[1])
    port.step(slipped[2])                                       # the hysteresis: 3 agree
    assert port.receiver.iq_repair_idx == 3


def test_block_must_be_a_multiple_of_512():
    _, tc = configs("USB")
    with pytest.raises(ValueError):
        Appliance(tc, block=1000, device="cpu")
