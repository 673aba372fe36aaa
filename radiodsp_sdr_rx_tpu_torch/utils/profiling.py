"""Tracing (``radiodsp_sdr_rx_tpu/utils/profiling.py``).

- ``trace(logdir)``: ``torch.profiler`` around a block of work, the host and
  the card, written into ``logdir`` as a Chrome trace (chrome://tracing,
  Perfetto). The port's spans appear in it by name.
- ``span(name, **attrs)``: one of the port's spans. Tracing is on exactly
  while a torch profiler records (``torch.autograd._profiler_enabled()``:
  ``trace``, or any ``torch.profiler.profile``); off, a span is one check and
  a shared null context. On, it is a host event of the profiler (a
  ``_RecordFunctionFast`` of function scope, which the profiler does not
  mirror on the device's timeline) and a record in memory: its name, start
  and end on ``time.time_ns()`` (the clock of the profiler's host events),
  its parent, the call it belongs to and its attributes.
- ``spans()``: the latest session, the spans recorded since tracing last
  turned on (``Session``). The profiler records the thread that started it,
  so tracing is on or off in each thread: a span that finds it on in a
  thread where a span last found it off starts a new session; a thread's
  spans nest under that thread's open spans.

The spans of the fused banks' ``process_planar`` (``models/fused.py``) and
of the kernel wrappers:

  rdsp.entry   one call of a bank's ``process_planar``; ``bank``: its class.
               Its self time (its duration less its children's) is the
               building of the chain's arguments
  rdsp.upload  the input planes to the bank's device (``fused._planar``);
               ``bytes``: what crossed from the host, 0 where the planes
               were on the device already
  rdsp.chain   the chain: on the card its wrapper's checks, output
               allocation and launch; on the CPU the plain chain
  rdsp.launch  a wrapper's call into its kernel library, beside its launch
               counter; ``kernel``: the name the counter uses
  rdsp.state   the next state: the DDS phase, the tails, the padding of the
               carries
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

from radiodsp_sdr_rx_tpu_torch.utils.convert import resolve_device

MAX_SPANS = 1 << 20   # a session's record; spans past it are counted, not kept
ENTRY = "rdsp.entry"

_NULL = contextlib.nullcontext()
_enabled = torch.autograd._profiler_enabled
# the profiler's host event without a device mirror; absent from some
# builds of torch, where the spans are kept in memory only
_RECORD = getattr(getattr(torch._C, "_profiler", None), "_RecordFunctionFast", None)


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Profile the block into ``logdir``/trace_<pid>_<ns>.json: the host's
    operators and the port's spans and, on a card (``device=None``), its
    kernels and copies; ``device="cpu"`` traces the host alone. Yields the
    profiler; the block's spans are ``spans()`` afterwards."""
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)   # the block's kernels end inside the trace
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class Span:
    """One recorded span: ``name``, ``start_ns`` and ``end_ns`` (``time.time_ns``;
    ``end_ns`` None while open), ``index`` (its place in the session's list,
    None when dropped), ``parent`` (the index of the span it opened in, None
    at the top), ``call`` (the number of the enclosing ``rdsp.entry`` in the
    session, None outside one) and ``attrs``."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "call", "attrs", "index")

    def __init__(self, name: str, parent, call, attrs: dict, index):
        self.name, self.parent, self.call, self.attrs, self.index = name, parent, call, attrs, index
        self.start_ns = self.end_ns = None


class Session:
    """The spans recorded since tracing last turned on, in the order they
    began; ``dropped`` counts those past ``MAX_SPANS``, which are not kept;
    ``calls`` the ``rdsp.entry`` spans begun."""

    def __init__(self):
        self.spans: list[Span] = []
        self.dropped = 0
        self.calls = 0


_session = Session()
# each thread's open spans (``stack``, innermost last), and ``off``: a span
# of the thread found tracing off since the latest session began
_local = threading.local()


class _Open:
    """A span while tracing is on."""

    __slots__ = ("name", "attrs", "span", "event", "stack")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> Span:
        global _session
        if getattr(_local, "off", False):
            _session, _local.off = Session(), False
        session = _session
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        outer = stack[-1] if stack else None
        if self.name == ENTRY:
            call = session.calls
            session.calls += 1
        else:
            call = None if outer is None else outer.call
        full = len(session.spans) >= MAX_SPANS
        span = Span(self.name, None if outer is None else outer.index, call, self.attrs,
                    None if full else len(session.spans))
        if full:
            session.dropped += 1
        else:
            session.spans.append(span)
        stack.append(span)
        self.span, self.stack = span, stack
        self.event = None
        if _RECORD is not None:
            self.event = _RECORD(self.name)
            self.event.__enter__()
        span.start_ns = time.time_ns()
        return span

    def __exit__(self, *exc) -> None:
        self.span.end_ns = time.time_ns()
        if self.event is not None:
            self.event.__exit__(*exc)
        self.stack.pop()


def span(name: str, **attrs):
    """A context manager around one stretch of the port's work (the module's
    list of names). Off, it does nothing and yields None; on, it yields its
    ``Span``, whose ``attrs`` the stretch may add to."""
    if not _enabled():
        _local.off = True
        return _NULL
    return _Open(name, attrs)


def spans() -> Session:
    """The latest session: a span that finds tracing on after a span of its
    thread found it off starts a new one."""
    return _session
