"""The port's own spans of the traced window (``utils/profiling.spans()``
of ``radiodsp_sdr_rx_tpu_torch``), for the readers of ``program_span``
metrics.

``session(ctx)`` is the port's latest span session, or None: where the
program records no spans, or where that session is not the traced
window's, which has one ``rdsp.entry`` a call and dropped none. The other
functions total a session's spans by name, in milliseconds.
"""

from __future__ import annotations


def session(ctx):
    events = ctx["trace"]
    if events is None or not events["calls"]:
        return None
    try:
        from radiodsp_sdr_rx_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    got = spans() if spans is not None else None
    if got is None or got.dropped:
        return None
    entries = sum(1 for s in got.spans if s.name == "rdsp.entry")
    return got if entries == events["calls"] else None


def total_ms(got, name: str) -> float:
    """The summed duration of the session's spans called ``name``."""
    return sum(s.end_ns - s.start_ns for s in got.spans if s.name == name) * 1e-6


def count(got, name: str) -> int:
    return sum(1 for s in got.spans if s.name == name)


def self_ms(got, name: str) -> float:
    """The summed self time of the spans called ``name``: each one's
    duration less its children's."""
    spans = got.spans
    own = {i: s.end_ns - s.start_ns for i, s in enumerate(spans) if s.name == name}
    for s in spans:
        if s.parent in own:
            own[s.parent] -= s.end_ns - s.start_ns
    return sum(own.values()) * 1e-6


def per_call_ms(ctx, name: str, self_time: bool = False):
    """The spans called ``name`` a call of the traced window, in ms, or None
    where the session is not the window's or has no such span."""
    got = session(ctx)
    if got is None or not count(got, name):
        return None
    return (self_ms(got, name) if self_time else total_ms(got, name)) / ctx["trace"]["calls"]
