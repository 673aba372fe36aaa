"""device_idle_pct: the share of the traced window in which the device runs
no kernel, copy or set (profiler). Reads device_idle_pct.seg and
device_idle_pct.live alike."""

from rxbench import trace


def read(ctx):
    events = ctx["trace"]
    if events is None or events["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(events) / events["window_s"])
