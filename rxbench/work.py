"""The work a call does and the least time the card could take for it.

A configuration's ``work/<config>.json`` counts the firmware's algorithm,
independent of how the program computes it: the FFTs of the overlap-save
stages (5 N log2 N flops each, ``ffts_per_block`` of them a 128-sample
block), their mask products (6 flops a complex product), the per-sample
operations of the other stages, and the bytes a sample moves, each input
byte read once and each output byte written once. ``peaks.json`` holds each
card's published peaks, by the name ``torch.cuda.get_device_name`` gives.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def per_call(work: dict, channels: int, samples: int) -> dict:
    """{"flops", "bytes"} of one call of ``channels`` x ``samples``."""
    n_fft = int(work["fft_points"])
    blocks = channels * samples // int(work["block"])
    fft = 5.0 * n_fft * math.log2(n_fft)
    per_block = work["ffts_per_block"] * fft + work["mask_products_per_block"] * 6.0
    per_sample = sum(work["flops_per_sample"].values())
    return {"flops": blocks * per_block + channels * samples * per_sample,
            "bytes": channels * samples * sum(work["bytes_per_sample"].values())}


def peaks(kind: str) -> dict | None:
    with open(PEAKS) as f:
        return json.load(f)["cards"].get(kind)


def least_time_s(counts: dict, peak: dict) -> tuple[float, str]:
    """(seconds, "operations" or "bytes"): the larger of the two times."""
    t_ops = counts["flops"] / peak["fp32_accurate_flops_per_s"]
    t_bytes = counts["bytes"] / peak["bytes_per_s"]
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")
