"""The profiler's trace, reduced to what the readers need.

``collect`` keeps, from ``torch.profiler``'s events, every device operation
(kernel, copy, set) and the harness's host spans, on the profiler's one
clock, in microseconds, and the window's span ("window"). ``busy_s`` is the
union of the device operations inside the window; ``breakdown`` the device
operations by total time and the longest idle gaps of the device, each
named by the harness span that was open on the host meanwhile.
"""

from __future__ import annotations

import torch

NAME_CHARS = 96   # a device operation's name as the breakdown gives it


def collect(prof, span_names) -> dict:
    device, spans, window = [], [], None
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        if e.name == "window" or e.name in span_names:
            # the profiler mirrors each annotation on the device's timeline:
            # that copy is no device work
            if on_device:
                continue
            if e.name == "window":
                window = (start, end)
            else:
                spans.append((start, end, e.name))
        elif on_device:
            device.append((start, end, e.name))
    if window is None:
        raise RuntimeError("the profiler lost the window's span")
    lo, hi = window
    device = sorted((max(s, lo), min(e, hi), n) for s, e, n in device if e > lo and s < hi)
    return {"device": device, "spans": sorted(spans), "window": window,
            "window_s": (hi - lo) * 1e-6}


def busy_intervals(events: dict) -> list:
    merged = []
    for s, e, _ in events["device"]:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_s(events: dict) -> float:
    return sum(e - s for s, e in busy_intervals(events)) * 1e-6


def idle_gaps(events: dict) -> list:
    """(start, end) of every stretch of the window with no device operation."""
    gaps, at = [], events["window"][0]
    for s, e in busy_intervals(events):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if events["window"][1] > at:
        gaps.append((at, events["window"][1]))
    return gaps


def span_at(events: dict, t: float) -> str:
    """The harness span open on the host at time t (the latest begun)."""
    name = "none"
    for s, e, n in events["spans"]:
        if s > t:
            break
        if e >= t:
            name = n
    return name


def device_time_by_name(events: dict) -> dict:
    total: dict = {}
    for s, e, n in events["device"]:
        total[n] = total.get(n, 0.0) + (e - s) * 1e-6
    return total


def breakdown(events: dict, top: int = 10) -> dict:
    ops = sorted(device_time_by_name(events).items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(events), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:NAME_CHARS], t] for n, t in ops],
            "idle_gaps": [[span_at(events, (s + e) / 2), (e - s) * 1e-6] for s, e in gaps]}
