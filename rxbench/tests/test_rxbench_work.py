"""The work counts give the totals PERF.md states, a 128 x 2^19 segment."""

import json
from pathlib import Path

import pytest

from rxbench import work

ROOT = Path(__file__).resolve().parent.parent
PEAK = {"bytes_per_s": 3.35e12, "fp32_accurate_flops_per_s": 495e12 / 3}


@pytest.mark.parametrize("config, flops_per_sample, bytes_per_sample, binds", [
    ("usb128", 361, 16, "bytes"),
    ("usb128_dnr2", 937, 12, "operations"),
])
def test_segment_totals(config, flops_per_sample, bytes_per_sample, binds):
    counts = work.per_call(json.loads((ROOT / "work" / f"{config}.json").read_text()),
                           128, 1 << 19)
    assert counts["flops"] == 128 * (1 << 19) * flops_per_sample
    assert counts["bytes"] == 128 * (1 << 19) * bytes_per_sample
    assert work.least_time_s(counts, PEAK)[1] == binds


def test_the_h100_peaks_are_the_data_sheets():
    assert work.peaks("NVIDIA H100 80GB HBM3") == PEAK
    assert work.peaks("cpu") is None
