"""The reference against the port's plain versions and against the plain
sample-by-sample recurrences, at a tiny size on the CPU. The test imports
the port; the reference does not."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from rxbench import checks, harness
from rxbench.reference import ssb_chain

ROOT = Path(__file__).resolve().parent.parent
MIX = json.loads((ROOT / "traffic" / "seg19.json").read_text())
ssb_voice = harness.load_module(ROOT / "generators" / "ssb_voice.py")


def settings(config, channels):
    s = json.loads((ROOT / "configs" / f"{config}.json").read_text())
    s["channels"] = channels
    return s


def rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.parametrize("config", ["usb128", "usb128_dnr2"])
def test_reference_matches_the_ports_plain_bank_over_threaded_spans(config):
    from rxbench.entries import fused_bank

    s = settings(config, 5)
    xr, xi = ssb_voice.make_capture(MIX, s, 0, 77, "cpu", 5, 3 * 1024)
    bank = fused_bank.make(s, "cpu")
    ref = ssb_chain.make(s, "cpu")
    st, rst = bank.init_state(), ref.init_state()
    for t0 in range(0, 3 * 1024, 1024):
        out, st = bank.process_planar(xr[:, t0:t0 + 1024], xi[:, t0:t0 + 1024], st)
        rout, rst = ref.process(xr[:, t0:t0 + 1024], xi[:, t0:t0 + 1024], rst)
        for key in ("audio_l", "audio_r"):
            assert rel(out[key], rout[key]) < 1e-5
        view = fused_bank.state_view(bank, st)
        assert torch.equal(view["nco_phase"], rst["nco_phase"])
        assert torch.equal(view["sb_tail"], rst["sb_tail"])
        for key in (set(view) & set(checks.tensors(rst))) - {"nco_phase", "sb_tail"}:
            assert rel(view[key], rst[key]) < 1e-5, key


def test_agc_is_the_decaying_maximum():
    ref = ssb_chain.make(settings("usb128", 2), "cpu")
    a = torch.randn(2, 640) * torch.linspace(2, 0.01, 640)
    got, env_last = ref._agc(a, torch.tensor([1e-6, 3.0]))
    r = float(ref.release)
    for c in range(2):
        env = [1e-6, 3.0][c]
        for k in range(640):
            env = max(abs(float(a[c, k])), env * r)
            gain = min(0.5 / max(env, 1e-12), 316.0)
            assert math.isclose(float(got[c, k]), float(a[c, k]) * gain, rel_tol=1e-5, abs_tol=1e-9)
        assert math.isclose(float(env_last[c]), env, rel_tol=1e-5)


def test_nlms_is_the_sample_by_sample_recurrence():
    ref = ssb_chain.make(settings("usb128_dnr2", 3), "cpu")
    x = torch.randn(3, 700, dtype=torch.float64)
    state = {"lms_weights": torch.randn(3, 96, dtype=torch.float64) * 0.01,
             "lms_window": torch.randn(3, 96, dtype=torch.float64),
             "lms_delay": torch.randn(3, 128, dtype=torch.float64), "lms_first": True}
    y, w, window, delay = ref.nlms(x, state)
    hist = torch.cat([state["lms_window"], x], 1)
    past = torch.cat([state["lms_delay"], x], 1)
    wt = state["lms_weights"].clone()
    for n in range(700):
        win = hist[:, n + 1:n + 97]
        d = x[:, n] if n < 128 else past[:, n]
        pred = (wt * win).sum(1)
        assert torch.allclose(y[:, n], pred, rtol=1e-9, atol=1e-9)
        wt = wt + (ref.mu * (d - pred) / ((win * win).sum(1) + ssb_chain.LMS_EPS))[:, None] * win
    assert torch.allclose(w, wt, rtol=1e-9, atol=1e-9)
    assert torch.equal(window, x[:, -96:]) and torch.equal(delay, x[:, -128:])


def test_frame_map_is_the_overlap_save_chain():
    mask = ssb_chain.band_mask(300.0, 3000.0, 44117.64706, 256, 129, 1)
    a = ssb_chain.frame_map(mask)
    frame = np.random.default_rng(3).standard_normal(256) + 0j
    want = np.fft.ifft(mask * np.fft.fft(frame))[128:]
    assert np.allclose(a @ frame, want, atol=1e-12)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12, -3.0])
    got = ssb_chain.tf32_round(x)
    assert got.tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -3.0]
