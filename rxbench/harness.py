"""One run of one cell: set-up, the measured window, the readers, the check.

Everything that belongs to one configuration, traffic mix, cell or metric
is found by name in files of its own (``rxbench/README.md``):

  configs/<config>.json    the receiver's settings, its entry and reference, and
                           which outputs and state the comparison holds
  entries/<entry>.py       builds the program's entry from those settings
  reference/<ref>.py       the plain reference of the configuration's chain
  work/<config>.json       the work a call does, counted from the firmware
  traffic/<traffic>.json   the mix: its generator, capture, call and pool sizes, the loop
  generators/<gen>.py      makes one capture of a mix from the seed
  cells/<cell>.json        the limits of the comparison that decides correct
  metrics/<metric>.py      one reader a metric; a metric ``a.b`` without a file
                           of its own is read by ``metrics/a.py``

The traffic's ``loop`` picks one of the two windows here: "device_segments"
(the pool on the device, calls dispatched ahead with ``in_flight`` calls at
most in flight) or "host_blocks" (the pool in page-locked host memory, one
block in flight, its outputs copied back to page-locked host buffers before
the next block goes in). Each capture starts from the entry's
``init_state()`` and threads the state through its calls; the pool's
captures are cycled. A ``--trace 1`` run measures two windows of the same
length: one untraced, which the host-clock readers read, then one under the
profiler, which the trace's readers read.
"""

from __future__ import annotations

import collections
import contextlib
import importlib.util
import json
import random
import sys
import time
from pathlib import Path

import torch

from rxbench import checks, trace, work

ROOT = Path(__file__).resolve().parent
SPAN_NAMES = ("entry_call", "readback", "state_reset", "handover")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"rxbench_{path.parent.name}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader_path(name: str) -> Path:
    """metrics/<name>.py, or metrics/<name before its first dot>.py."""
    own = ROOT / "metrics" / f"{name}.py"
    return own if own.is_file() else ROOT / "metrics" / f"{name.split('.')[0]}.py"


def manifest() -> dict:
    return load_json(ROOT.parent / "BENCHMARK.json")


def cell_spec(name: str, bench: dict | None = None) -> dict:
    """The cell's entry in BENCHMARK.json with its files loaded, and the
    metrics it reports: end-to-end ones (with --trace 0) and per-layer ones
    (with --trace 1), each those whose ``workloads`` name it or that have
    none."""
    bench = manifest() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]

    def mine(metric):
        return name in metric.get("workloads", [name])

    return {"workload": w,
            "settings": load_json(ROOT / "configs" / f"{w['config']}.json"),
            "traffic": load_json(ROOT / "traffic" / f"{w['traffic']}.json"),
            "limits": load_json(ROOT / "cells" / f"{name}.json")["limits"],
            "work": load_json(ROOT / "work" / f"{w['config']}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


class Spans:
    """The harness's host spans; profiler annotations while tracing, free
    otherwise."""

    def __init__(self, tracing: bool):
        self.tracing = tracing

    def __call__(self, name: str):
        if self.tracing:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()


def distinct(out: dict) -> dict:
    """The outputs, each tensor once (a plane that is another's, R <- L, is
    kept under its first key)."""
    seen: dict = {}
    for key, t in out.items():
        if not any(t is v for v in seen.values()):
            seen[key] = t
    return seen


class PassSampler:
    """One pass through a capture, drawn from the seed uniformly among the
    passes the run starts (reservoir sampling, decided at each pass's
    start): every call of it is kept, its outputs and threaded state, for
    the comparison with the reference. The buffers that hold a pass are
    made once, from the warm-up's pass through the same path, and a kept
    call is copied into them: the window allocates nothing for the
    comparison."""

    def __init__(self, seed: int, per_capture: int):
        self.rng = random.Random(seed * 7919 + 17)
        self.per_capture = per_capture
        self.recording = False
        self.store: list = []   # (outputs, state view) buffers, one a call of a pass
        self.kept: list = []    # (capture, call) of the kept pass's calls, in order

    def start(self, n_pass: int):
        self.recording = self.rng.randrange(n_pass + 1) == 0
        if self.recording:
            self.kept = []

    def keep(self, capture: int, index: int, out: dict, view: dict):
        pos = len(self.kept)
        if pos == len(self.store):
            own = distinct(out)
            clones = {k: v.clone() for k, v in own.items()}
            outs = {k: next(clones[o] for o in own if own[o] is v) for k, v in out.items()}
            self.store.append((outs, {k: v.clone() for k, v in view.items()}))
        else:
            outs, saved = self.store[pos]
            for k, v in distinct(out).items():
                outs[k].copy_(v)
            for k, v in view.items():
                saved[k].copy_(v)
        self.kept.append((capture, index))

    def partial(self) -> bool:
        return self.recording and len(self.kept) < self.per_capture

    def calls(self) -> list:
        """The kept pass: (capture, call, outputs, state view) in order."""
        return [(c, s, *self.store[pos]) for pos, (c, s) in enumerate(self.kept)]


def _pool(spec: dict, seed: int, device, sizes: dict):
    """The captures, (captures, calls a capture, C, span) per plane: on the
    device, or page-locked on the host for "host_blocks"."""
    traffic, settings = spec["traffic"], spec["settings"]
    gen = load_module(ROOT / "generators" / f"{traffic['generator']}.py")
    n, span, caps = sizes["capture_samples"], sizes["span"], int(traffic["captures"])
    c = sizes["channels"]
    host = traffic["loop"] == "host_blocks"
    pin = host and device.type == "cuda"
    where = "cpu" if host else device
    planes = [torch.empty(caps, n // span, c, span, device=where, pin_memory=pin)
              for _ in range(2)]
    for j in range(caps):
        xr, xi = gen.make_capture(traffic, settings, j, sizes["seed"], device, c, n)
        for plane, x in zip(planes, (xr, xi)):
            plane[j].copy_(x.view(c, n // span, span).transpose(0, 1))
        del xr, xi
    return planes


class Loop:
    """The window's calls in order: call i is call s = i % per_capture of
    capture j = (i // per_capture) % captures, the state reset at each
    capture's start."""

    def __init__(self, bank, state_view, planes, traffic, sampler, device):
        self.bank, self.state_view, self.planes, self.sampler = bank, state_view, planes, sampler
        self.caps, self.per_capture = planes[0].shape[0], planes[0].shape[1]
        self.host = traffic["loop"] == "host_blocks"
        self.depth = int(traffic.get("in_flight", 1))
        self.device, self.cuda = device, device.type == "cuda"
        self.in_flight: collections.deque = collections.deque()
        self.out_host: dict | None = None
        self.state = None
        self.i = 0

    def readback(self, out: dict):
        own = distinct(out)
        if self.out_host is None:
            self.out_host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=self.cuda)
                             for k, v in own.items()}
        for key, buf in self.out_host.items():
            buf.copy_(own[key], non_blocking=True)

    def warm_up(self):
        """One capture of the cell's own shapes through the window's path,
        kept, so that the sampler's buffers exist before the window."""
        state = self.bank.init_state()
        for s in range(self.per_capture):
            out, state = self.bank.process_planar(self.planes[0][0, s], self.planes[1][0, s], state)
            if self.host:
                self.readback(out)
            self.sampler.keep(0, s, out, self.state_view(self.bank, state))
        self.sampler.kept = []
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def step(self, spans, call_s: list, block_s: list):
        j, s = (self.i // self.per_capture) % self.caps, self.i % self.per_capture
        if s == 0:
            self.sampler.start(self.i // self.per_capture)
            with spans("state_reset"):
                self.state = self.bank.init_state()
        xr, xi = self.planes[0][j, s], self.planes[1][j, s]
        if self.host:
            t0 = time.perf_counter()
            with spans("entry_call"):
                out, self.state = self.bank.process_planar(xr, xi, self.state)
            t1 = time.perf_counter()
            with spans("readback"):
                self.readback(out)
                if self.cuda:
                    torch.cuda.current_stream(self.device).synchronize()
            block_s.append(time.perf_counter() - t0)
        else:
            if len(self.in_flight) >= self.depth:
                with spans("handover"):
                    self.in_flight.popleft().synchronize()
            t0 = time.perf_counter()
            with spans("entry_call"):
                out, self.state = self.bank.process_planar(xr, xi, self.state)
            t1 = time.perf_counter()
            if self.cuda:
                ev = torch.cuda.Event()
                ev.record()
                self.in_flight.append(ev)
        call_s.append(t1 - t0)
        if self.sampler.recording:
            self.sampler.keep(j, s, out, self.state_view(self.bank, self.state))
        self.i += 1

    def window(self, seconds: float, tracing: bool) -> dict:
        """Calls for ``seconds`` seconds, from the host clock's open to the
        final synchronize; under the profiler if ``tracing``."""
        spans = Spans(tracing)
        prof = None
        if tracing:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        call_s, block_s, first = [], [], self.i
        with spans("window"):
            t_open = time.perf_counter()
            t_end = t_open + seconds
            while True:
                self.step(spans, call_s, block_s)
                if time.perf_counter() >= t_end:
                    break
            if self.cuda:
                torch.cuda.synchronize(self.device)
            t_close = time.perf_counter()
        self.in_flight.clear()
        events = None
        if prof is not None:
            prof.__exit__(None, None, None)
            events = trace.collect(prof, SPAN_NAMES)
            events["calls"] = self.i - first
        return {"calls": self.i - first, "window_s": t_close - t_open, "call_s": call_s,
                "block_s": block_s, "trace": events}

    def finish_sampled_pass(self):
        """The sampled pass's calls that the window's close cut off, untimed."""
        while self.sampler.partial():
            self.step(Spans(False), [], [])
        if self.cuda:
            torch.cuda.synchronize(self.device)


def run_cell(name: str, seed: int, seconds: float, tracing: bool, device="cuda",
             t_start: float | None = None, sizes: dict | None = None, entry=None,
             spec: dict | None = None) -> dict:
    """One run. ``sizes`` overrides the channels, capture and span (the CPU
    tests' tiny runs); ``entry`` = (make, state_view) replaces the
    configuration's entry (the control, and the tests' broken paths)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = cell_spec(name) if spec is None else spec
    settings, traffic = dict(spec["settings"]), spec["traffic"]
    device = torch.device(device)
    cuda = device.type == "cuda"
    sz = {"channels": int(settings["channels"]), "capture_samples": int(traffic["capture_samples"]),
          "span": int(traffic["span"]), "seed": int(seed)}
    sz.update(sizes or {})
    settings["channels"] = sz["channels"]
    if entry is None:
        mod = load_module(ROOT / "entries" / f"{settings['entry']}.py")
        entry = (mod.make, mod.state_view)
    make, state_view = entry
    marks = [time.perf_counter()]
    bank = make(settings, device)
    marks.append(time.perf_counter())
    planes = _pool(spec, seed, device, sz)
    marks.append(time.perf_counter())
    loop = Loop(bank, state_view, planes, traffic,
                PassSampler(seed, sz["capture_samples"] // sz["span"]), device)
    loop.warm_up()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(time.perf_counter())
    setup_s = time.perf_counter() - t_start

    host = loop.window(seconds, False)
    traced = loop.window(seconds, True) if tracing else None
    loop.finish_sampled_pass()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kept = loop.sampler.calls()
    del loop, bank
    if cuda:
        torch.cuda.empty_cache()

    ctx = {"setup_s": setup_s, "calls": host["calls"], "window_s": host["window_s"],
           "call_s": host["call_s"], "block_s": host["block_s"],
           "trace": traced["trace"] if traced else None,
           "samples_per_call": sz["channels"] * sz["span"],
           "device_kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "work_per_call": work.per_call(spec["work"], sz["channels"], sz["span"])}
    wanted = spec["per_layer"] if tracing else spec["end_to_end"]
    metrics = {}
    for m in wanted:
        value = load_module(reader_path(m["name"])).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    ref = load_module(ROOT / "reference" / f"{settings['reference']}.py").make(settings, device)
    t_ref = time.perf_counter()
    readings, failed = checks.compare(ref, planes, kept, sz["span"], settings, spec["limits"])
    split = ", ".join(f"{what} {b - a:.3f}" for what, a, b in zip(
        ("to the entry", "entry", "pool", "warm-up"), [t_start] + marks, marks))
    print(f"rxbench: {name} seed {seed}: set-up {setup_s:.3f} s ({split}), window "
          f"{host['window_s']:.3f} s, {host['calls']} calls"
          + (f", traced window {traced['window_s']:.3f} s, {traced['calls']} calls" if traced else "")
          + f"; compared {len(kept)} calls of capture {kept[0][0] if kept else None}, "
          f"reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    attempted = host["calls"] + (traced["calls"] if traced else 0)
    result = {"correct": all(r["value"] <= r["limit"] for r in readings.values()),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": ctx["device_kind"], "count": 1,
                         "memory_peak_bytes": int(peak)}}
    if traced:
        events = traced["trace"]
        result["device"].update(busy_s=trace.busy_s(events), window_s=events["window_s"])
        result["breakdown"] = trace.breakdown(events)
    result["checks"] = readings   # last: the numbers compared beside their limits
    return result
