"""entry_call_ms: the host clock around each call of the entry's
process_planar, with no synchronize, averaged over the calls of the
untraced window (in a --trace 1 run, the window measured before the traced
one, so the profiler's cost per operator is not in it). Reads
entry_call_ms.seg and entry_call_ms.live alike."""


def read(ctx):
    calls = ctx["call_s"]
    return sum(calls) / len(calls) * 1e3 if calls else None
