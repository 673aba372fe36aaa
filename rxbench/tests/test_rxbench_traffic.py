"""The generators: each traffic mix's gives the same capture for the same
seed, another for another seed, at the same sizes."""

import json
from pathlib import Path

import pytest
import torch

from rxbench import harness

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
SETTINGS = json.loads((ROOT / "configs" / "usb128.json").read_text())
ssb_voice = harness.load_module(ROOT / "generators" / "ssb_voice.py")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_same_seed_same_capture_other_seed_other(cell):
    spec = harness.cell_spec(cell)
    mix, settings = spec["traffic"], spec["settings"]
    gen = harness.load_module(ROOT / "generators" / f"{mix['generator']}.py")
    one = gen.make_capture(mix, settings, 0, 2**31 + 11, "cpu", 4, 2048)
    again = gen.make_capture(mix, settings, 0, 2**31 + 11, "cpu", 4, 2048)
    other = gen.make_capture(mix, settings, 0, 2**31 + 12, "cpu", 4, 2048)
    second = gen.make_capture(mix, settings, 1, 2**31 + 11, "cpu", 4, 2048)
    for a, b in zip(one, again):
        assert torch.equal(a, b)
    for a, b, c in zip(one, other, second):
        assert a.shape == b.shape == (4, 2048) and a.dtype == torch.float32
        assert not torch.equal(a, b) and not torch.equal(a, c)


def test_station_sits_in_the_channels_passband():
    mix = json.loads((ROOT / "traffic" / "seg19.json").read_text())
    quiet = dict(mix, noise_sigma=0.0)
    xr, xi = ssb_voice.make_capture(quiet, SETTINGS, 0, 5, "cpu", 3, 1 << 14)
    fs = SETTINGS["sample_rate"]
    for k in range(3):
        spec = torch.fft.fft(torch.complex(xr[k].double(), xi[k].double())).abs()
        freqs = torch.fft.fftfreq(1 << 14, 1 / fs)
        f = freqs[int(spec.argmax())].item()
        base = (SETTINGS["first_channel_hz"] - SETTINGS["capture_center_hz"]
                + SETTINGS["channel_spacing_hz"] * k)
        assert base + 300 <= f <= base + 3000
