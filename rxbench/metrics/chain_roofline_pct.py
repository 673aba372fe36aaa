"""chain_roofline_pct: the least time the card could take for the window's
work (work/<config>.json, priced by peaks.json: the larger of the
operations at the fp32-accurate tensor-core rate and the bytes at the
memory's rate) over the device time of every operation the traced window's
calls ran (kernels, copies, sets; profiler)."""

import sys

from rxbench import trace, work


def read(ctx):
    events = ctx["trace"]
    peak = work.peaks(ctx["device_kind"])
    if events is None or peak is None or not events["calls"]:
        return None
    device_s = sum(trace.device_time_by_name(events).values())
    if device_s <= 0:
        return None
    least, binds = work.least_time_s(ctx["work_per_call"], peak)
    print(f"chain_roofline_pct: {binds} bind, {least * 1e3:.4f} ms a call", file=sys.stderr)
    return 100.0 * least * events["calls"] / device_s
