"""The port's spans (``utils/profiling.span``): off unless a torch profiler
records, then one ``rdsp.entry`` a bank call with its ``rdsp.upload``,
``rdsp.chain`` and ``rdsp.state`` children, host events of the profiler
with no device mirror, stamped on the profiler's clock; the benchmark's
readers of them (``rxbench/program_spans.py``, ``rxbench/metrics``).

On the CPU with small banks; the last test (``cuda`` marker) runs the live
cell's bank on the card: ``python -m pytest tests/test_torch_spans.py -q
--noconftest -m cuda``."""

import ctypes
import json
import struct
import threading
from pathlib import Path

import pytest
import torch

from radiodsp_sdr_rx_tpu_torch.parallel import halo
from radiodsp_sdr_rx_tpu_torch.utils import profiling
from rxbench import harness, program_spans
from rxbench.entries import fused_bank

ROOT = Path(__file__).resolve().parent.parent
CHANNELS, N = 4, 1024
CHILDREN = ["rdsp.upload", "rdsp.chain", "rdsp.state"]


def bank(config: str, device="cpu", channels=CHANNELS):
    settings = json.loads((ROOT / "rxbench" / "configs" / f"{config}.json").read_text())
    settings["channels"] = channels
    return fused_bank.make(settings, device)


def planes(seed: int, channels=CHANNELS, n=N):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(channels, n, generator=g) * 0.1 for _ in range(2)]


def profiled(fn):
    """fn() under a CPU profiler; returns (the profiler, the session)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof, profiling.spans()


def run_calls(b, calls: int, seed=3):
    state = b.init_state()
    for k in range(calls):
        xr, xi = planes(seed + k)
        _, state = b.process_planar(xr, xi, state)


def untraced_call(b):
    run_calls(b, 1)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on a card, to reach a launch's host side."""

    @property
    def is_cuda(self):
        return True


def _ring_stand_in(monkeypatch):
    """K9's one-card launch on a stand-in for its C entry: it copies by the
    pointer tables, as ``tests/test_torch_halo.py`` holds it."""

    def shift(srcs, dsts, pairs, floats, device, stream):
        for src, dst in zip(struct.unpack(f"{pairs}Q", srcs), struct.unpack(f"{pairs}Q", dsts)):
            ctypes.memmove(dst, src, floats * 4)
        return 0

    monkeypatch.setattr(halo, "_library", lambda: {"ring_shift": shift})
    monkeypatch.setattr(halo, "_raw_stream", lambda index: 0)
    return [torch.full((3, 5), float(k)).as_subclass(_OnCard) for k in range(4)]


def test_off_records_nothing_and_the_counters_count(monkeypatch):
    blocks = _ring_stand_in(monkeypatch)
    b = bank("usb128")
    untraced_call(b)
    assert not torch.autograd._profiler_enabled()
    before, count, launches = profiling.spans(), len(profiling.spans().spans), halo.LAUNCHES
    run_calls(b, 2)
    halo.ring_shift_right(blocks)
    assert halo.LAUNCHES == launches + 1
    assert profiling.spans() is before and len(before.spans) == count
    # off, every span is the one shared null context, which yields nothing
    off = profiling.span("rdsp.entry", bank="x")
    assert off is profiling.span("rdsp.chain")
    with off as s:
        assert s is None


@pytest.mark.parametrize("config", ["usb128", "usb128_dnr2"])
def test_one_entry_a_call_with_its_children(config):
    """A small FusedSSBBank and a FusedNRBank(fold=True) on the LMS (DNR2)
    route: three calls, three ``rdsp.entry`` spans, each the parent of an
    upload, a chain and a state span in that order, all of its call."""
    b = bank(config)
    assert type(b).__name__ == {"usb128": "FusedSSBBank", "usb128_dnr2": "FusedNRBank"}[config]
    untraced_call(b)
    _, got = profiled(lambda: run_calls(b, 3))
    spans = got.spans
    entries = [s for s in spans if s.name == "rdsp.entry"]
    assert got.calls == len(entries) == 3 and got.dropped == 0
    for k, e in enumerate(entries):
        assert e.call == k and e.parent is None and e.attrs == {"bank": type(b).__name__}
        kids = [s for s in spans if s.parent == e.index]
        assert [s.name for s in kids] == CHILDREN
        assert all(s.call == k for s in kids)
        assert e.start_ns <= kids[0].start_ns and kids[-1].end_ns <= e.end_ns
        assert all(a.end_ns <= c.start_ns for a, c in zip(kids, kids[1:]))
        assert kids[0].attrs == {"bytes": 0}   # the CPU bank: nothing crossed from a host
    # the CPU runs the plain chains: no launch
    assert {s.name for s in spans} == {"rdsp.entry", *CHILDREN}


def test_spans_are_host_events_of_the_profiler_and_share_its_clock():
    """Each span is a CPU event of the profiler that is no user annotation
    (so it gets no copy on the device's timeline), and its stamps lie
    within 100 us of the profiler's own times of that event."""
    b = bank("usb128")
    untraced_call(b)
    prof, got = profiled(lambda: run_calls(b, 4))
    events = [e for e in prof.events() if e.name.startswith("rdsp.")]
    assert len(events) == len(got.spans) == 16
    assert all(e.device_type == torch.autograd.DeviceType.CPU and not e.is_user_annotation
               for e in events)
    kineto = sorted((k for k in prof.profiler.kineto_results.events()
                     if k.name().startswith("rdsp.")), key=lambda k: k.start_ns())
    mine = sorted(got.spans, key=lambda s: s.start_ns)
    assert [k.name() for k in kineto] == [s.name for s in mine]
    for k, s in zip(kineto, mine):
        assert abs(k.start_ns() - s.start_ns) < 100_000, s.name
        assert abs(k.end_ns() - s.end_ns) < 100_000, s.name


def test_a_second_traced_stretch_replaces_the_session():
    b = bank("usb128")
    untraced_call(b)
    _, first = profiled(lambda: run_calls(b, 2))
    untraced_call(b)
    _, second = profiled(lambda: run_calls(b, 3))
    assert second is not first and profiling.spans() is second
    assert (first.calls, second.calls) == (2, 3)
    assert [s.call for s in second.spans if s.name == "rdsp.entry"] == [0, 1, 2]
    assert len(first.spans) == 8   # the first session as it was


def test_launch_span_beside_the_counter(monkeypatch):
    """A wrapper's call into its library is an ``rdsp.launch`` span named as
    its counter, inside a bank's call or alone."""
    blocks = _ring_stand_in(monkeypatch)
    untraced_call(bank("usb128"))
    launches = halo.LAUNCHES
    _, got = profiled(lambda: halo.ring_shift_right(blocks))
    assert halo.LAUNCHES == launches + 1
    [s] = got.spans
    assert (s.name, s.attrs, s.parent, s.call) == ("rdsp.launch", {"kernel": "ring_shift"},
                                                   None, None)
    assert s.end_ns >= s.start_ns


def test_parents_are_kept_per_thread(monkeypatch):
    """The profiler records the thread that started it: a bank's call in
    another thread, off, leaves the traced thread's session whole. Where
    two threads trace at once, each nests under its own open spans."""
    b = bank("usb128")
    untraced_call(b)

    def with_a_call_in_another_thread():
        run_calls(b, 1)
        t = threading.Thread(target=untraced_call, args=(b,))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        run_calls(b, 1)

    _, got = profiled(with_a_call_in_another_thread)
    assert profiling.spans() is got and got.calls == 2 and len(got.spans) == 8

    start = threading.Barrier(2, timeout=30)

    def nest(name):
        start.wait()
        with profiling.span("rdsp.entry", bank=name):
            start.wait()
            with profiling.span("rdsp.chain"):
                start.wait()

    monkeypatch.setattr(profiling, "_enabled", lambda: True)   # on in every thread
    ts = [threading.Thread(target=nest, args=(n,)) for n in ("a", "b")]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert profiling.spans() is got   # new threads: none found tracing off
    entries = {s.index: s for s in got.spans[8:] if s.name == "rdsp.entry"}
    chains = [s for s in got.spans[8:] if s.name == "rdsp.chain"]
    assert len(entries) == len(chains) == 2
    assert {entries[c.parent].attrs["bank"] for c in chains} == {"a", "b"}
    assert all(c.call == entries[c.parent].call for c in chains)


def test_the_record_is_bounded(monkeypatch):
    """Past ``MAX_SPANS`` spans are counted as dropped, not kept."""
    b = bank("usb128")
    untraced_call(b)
    monkeypatch.setattr(profiling, "MAX_SPANS", 5)
    _, got = profiled(lambda: run_calls(b, 2))
    assert len(got.spans) == 5 and got.dropped == 3 and got.calls == 2


def live_tiny(seed):
    return harness.run_cell("usb128.live16k", seed, 0.3, True, device="cpu",
                            sizes={"channels": CHANNELS, "capture_samples": 4096, "span": 512})


def test_the_live_cells_split_adds_up_to_the_entry():
    """A tiny traced run of usb128.live16k on the CPU reports the entry's
    split, whose parts sum to the session's mean ``rdsp.entry``."""
    result = live_tiny(2**31 + 11)
    got = profiling.spans()
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    parts = ["upload_ms.live", "chain_host_ms.live", "state_ms.live", "entry_self_ms.live"]
    assert set(parts) <= set(metrics) and result["correct"]
    assert "upload_gb_s.live" not in metrics and "launch_ms.live" not in metrics   # CPU: none
    entry = program_spans.total_ms(got, "rdsp.entry") / got.calls
    assert abs(sum(metrics[p] for p in parts) - entry) <= 0.01 * entry
    assert all(metrics[p] > 0 for p in parts)


def test_the_session_helper_wants_the_traced_windows_calls():
    """``program_spans.session`` returns the latest session only where its
    entries are the traced window's calls and it dropped none."""
    b = bank("usb128")
    untraced_call(b)
    _, got = profiled(lambda: run_calls(b, 3))
    assert program_spans.session({"trace": {"calls": 3}}) is got
    assert program_spans.session({"trace": {"calls": 4}}) is None
    assert program_spans.session({"trace": None}) is None
    assert program_spans.per_call_ms({"trace": {"calls": 2}}, "rdsp.chain") is None
    ctx = {"trace": {"calls": 3}}
    assert program_spans.per_call_ms(ctx, "rdsp.launch") is None   # none on the CPU
    assert program_spans.per_call_ms(ctx, "rdsp.chain") == pytest.approx(
        program_spans.total_ms(got, "rdsp.chain") / 3)
    got.dropped = 1
    assert program_spans.session(ctx) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_live_launches_precede_their_kernels_on_the_card(card):
    """The live cell's bank (128 ch x 16,384-sample blocks from page-locked
    memory, the audio read back each block), traced: one ``rdsp.launch``
    an entry, each begun before its kernel begins, and no ``rdsp.`` name
    among the device's events."""
    b = bank("usb128", card, channels=128)
    src = [p.pin_memory() for p in planes(7, 128, 16384)]
    out_host = None
    state = b.init_state()

    def blocks(k):
        nonlocal state, out_host
        for _ in range(k):
            out, state = b.process_planar(*src, state)
            if out_host is None:
                out_host = {n: torch.empty(v.shape, pin_memory=True) for n, v in out.items()}
            for n, v in out.items():
                out_host[n].copy_(v, non_blocking=True)
            torch.cuda.current_stream(card).synchronize()

    blocks(3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        blocks(16)
    got = profiling.spans()
    assert got.calls == 16 and program_spans.count(got, "rdsp.launch") == 16
    assert all(s.attrs == {"kernel": "sweep_chain_ssb"} for s in got.spans
               if s.name == "rdsp.launch")
    ups = [s for s in got.spans if s.name == "rdsp.upload"]
    assert all(s.attrs["bytes"] == 2 * 128 * 16384 * 4 for s in ups)
    events = list(prof.events())
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    assert not [e.name for e in on_device if e.name.startswith("rdsp.")]
    kernels = sorted(e.time_range.start for e in on_device if "ssb_fed_kernel" in e.name)
    launches = sorted(e.time_range.start for e in events if e.name == "rdsp.launch"
                      and e.device_type == torch.autograd.DeviceType.CPU)
    assert len(kernels) == len(launches) == 16
    assert all(a < k for a, k in zip(launches, kernels))
