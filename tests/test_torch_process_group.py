"""The port's sharded chains over a process group (gloo, CPU): equal to the
in-process mesh bit for bit, the kernel halo's plain exchange, and the
kernel halo across processes (``parallel/halo.GroupRing``) on the host.

One spawn of four processes (a module fixture, so the tests below share it)
joins a gloo group (a file rendezvous under a temporary directory, so
parallel test workers do not collide on a port) and builds:

  - ``make_global_mesh(channel=2, time=2)``: one shard per rank, the halos
    ``batch_isend_irecv``, the gathers ``all_gather``, the adaptive re-layout
    ``all_to_all_single``. Each rank runs USB/off, AM/notch and USB/spectral
    through ``make_full_sharded_chain`` over two threaded segments and gets
    the global result; rank 0 also runs the same on an in-process
    channel=2 x time=2 mesh, and every rank's output and state must equal it
    bit for bit (the same shard-local arithmetic; the collectives only move
    values).
  - ``make_global_mesh(channel=1, time=4, device="cpu")``: the time-sharded
    USB and AM chains with ``halo="kernel"``, which on CPU shards runs the
    plain exchange, equal bit for bit to the same group's ppermute halo and
    to the in-process time=4 mesh's kernel halo; rank 0's output goes back
    to the parent, which holds it within 1e-5 to the JAX chain with
    ``halo="pallas"`` on a time=4 mesh of the virtual CPU devices (the
    Pallas halo in the Mosaic interpreter), run while the ranks work.
  - ``GroupRing``'s host side on a stand-in for ``csrc/halo.cu`` (there is
    no card here): the handles gathered and the neighbours' opened, the
    order of the release, launch and wait calls that the flags on the host
    keep in step, through ``GroupAxis.shift_from_left(kernel=True)``
    on tensors that say they are on a card; a neighbour that cannot be
    opened and a launch that fails raise, and nothing falls back to
    ``batch_isend_irecv``; a ring dropped without ``close()`` (its
    finalizer, as at interpreter exit) frees its slots only after every rank
    of the line disconnected, and leaks them when one never does (fault F2).

``make_global_mesh(device=...)`` takes an explicit CPU device and raises for
a card that is not there. Every process is joined with a timeout and the
tests fail if one is left alive. The kernel halo on a card across processes
is in tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import contextlib
import ctypes
import gc
import io
import multiprocessing as mp
import tempfile
import time
import traceback

import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu_torch.models.config import AGCMode, DemodMode, ReceiverConfig
from radiodsp_sdr_rx_tpu_torch.models.receiver import build_params
from radiodsp_sdr_rx_tpu_torch.parallel import (
    halo, initialize_distributed, make_global_mesh, make_mesh, make_time_sharded_ssb_chain)
from radiodsp_sdr_rx_tpu_torch.parallel import collectives
from radiodsp_sdr_rx_tpu_torch.parallel.stream_shard import (
    make_full_sharded_chain, sharded_chain_init)
from radiodsp_sdr_rx_tpu_torch.utils import siggen

WORLD, C, N = 4, 8, 1024
COMBOS = [("usb", "off"), ("am", "notch"), ("usb", "spectral")]
JOIN_S = 150
FS = 44117.64706
N_1D = 4 * 8192   # the time-sharded chains' stream, 8,192 samples a shard
TOL_JAX = 1e-5    # sharded port against sharded JAX (PERF.md section 2)
MODES = ("usb", "am")
EXCHANGES = 10    # the ring's host side on a stand-in: past the slots' first round
SLOTS = 8         # the stand-in's receive slots a rank, as csrc/halo.cu's
STAGGER_S = 0.2   # the ranks drop their rings this far apart (rank r after r x this)
LEAK_WAIT_S = 0.5  # the disconnect wait of the rings whose neighbour never disconnects


def _args():
    p = build_params(ReceiverConfig(mode=DemodMode.USB, agc=AGCMode.FAST, vfo_freq=7_200_000.0,
                                    capture_center_freq=7_190_000.0, iq_gain_balance=1.0))
    return (p.w_sideband, p.w_audio, p.agc_release, p.agc_target, p.agc_max_gain,
            p.agc_enabled, p.output_gain)


def _config(mode: str) -> ReceiverConfig:
    """chip_smoke.py's time-sharded USB (AGC fast) and AM (AGC medium)."""
    return ReceiverConfig(mode=DemodMode.AM if mode == "am" else DemodMode.USB,
                          agc=AGCMode.MEDIUM if mode == "am" else AGCMode.FAST,
                          vfo_freq=7_060_000.0, capture_center_freq=7_050_000.0,
                          iq_gain_balance=1.0)


def _stream(mode: str) -> np.ndarray:
    if mode == "am":
        return siggen.am_signal(N_1D, 10_000.0, mod_hz=900.0, fs=FS).astype(np.complex64)
    audio = siggen.voice_like(N_1D, FS)
    return siggen.ssb_from_audio(audio, 10_000.0, FS, "usb", amp=0.4).astype(np.complex64)


def _chain_args(p):
    return (p.nco_inc, p.w_sideband, p.w_audio, p.agc_release, p.agc_target, p.agc_max_gain,
            p.output_gain)


def _run(mesh):
    rng = np.random.default_rng(7)
    iq = ((rng.standard_normal((C, 2 * N)) + 1j * rng.standard_normal((C, 2 * N))) * 0.2
          ).astype(np.complex64)
    incs = np.asarray([(k * 977 + 12345) * 65536 % (1 << 32) for k in range(C)], np.int64)
    out = {}
    for mode, nr in COMBOS:
        chain = make_full_sharded_chain(mesh, mode=mode, nr=nr, nr_level=30.0)
        st, audio = sharded_chain_init(C), []
        for seg in range(2):
            a, st = chain(iq[:, seg * N:(seg + 1) * N], incs, st, *_args())
            audio.append(a)
        out[(mode, nr)] = (torch.cat(audio, dim=1), st)
    return out


def _flat(v):
    return [x for e in v for x in _flat(e)] if isinstance(v, tuple) else [v]


def _time_sharded(rank, streams):
    """The time-sharded chains on a time=4 mesh over the group (explicit CPU
    device): kernel halo == ppermute halo on every rank, == the in-process
    mesh's kernel halo on rank 0, which also hands its output back."""
    mesh = make_global_mesh(channel=1, time=4, device="cpu")
    out = {"devices": [str(d) for row in mesh.devices for d in row if d is not None],
           "coords": mesh.coords()}
    for mode in MODES:
        am, args = mode == "am", _chain_args(build_params(_config(mode)))
        iq = torch.from_numpy(streams[mode])
        got = {h: make_time_sharded_ssb_chain(mesh, am=am, sample_rate=FS, halo=h)(iq, *args)
               for h in ("kernel", "ppermute")}
        same_halos = torch.equal(got["kernel"], got["ppermute"])
        same_local = None
        if rank == 0:
            local = make_mesh(channel=1, time=4, devices=[torch.device("cpu")] * 4)
            want = make_time_sharded_ssb_chain(local, am=am, sample_rate=FS,
                                               halo="kernel")(iq, *args)
            same_local = torch.equal(got["kernel"], want)
        out[mode] = (same_halos, same_local, got["kernel"].numpy() if rank == 0 else None)
    return mesh, out


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on a card, to reach the ring's host side."""

    @property
    def is_cuda(self):
        return True


def _fake_halo(rank, fail=None):
    """A stand-in for csrc/halo.cu's ring entries: records each call, checks
    that the handles a rank opens are its neighbours', and returns the error
    ``fail`` names for an entry (0 else). ``stamps`` holds the host clock's
    time of the last disconnect and destroy."""
    calls, stamps, fail = [], {}, fail or {}

    def last(name):
        def call(ring):
            calls.append((name,))
            stamps[name] = time.monotonic()
        return call
    size = 320

    def create(index, floats, ring, slots, handles):
        ring._obj.value, slots._obj.value = 1000 + rank, 2000 + rank
        ctypes.memmove(handles, bytes([rank]) * size, size)
        calls.append(("create", floats))
        return fail.get("create", 0)

    def connect(ring, left, right):
        calls.append(("connect", None if left is None else left[0],
                      None if right is None else right[0]))
        return fail.get("connect", 0)

    def entry(name):
        def call(ring, slot, *rest):
            calls.append((name, slot) + ((rest[1] is not None,) if name == "send" else ()))
            return fail.get(name, 0)
        return call

    funcs = {"group_ring_handles_size": lambda: size, "group_ring_slots": lambda: SLOTS,
             "group_ring_create": create,
             "group_ring_connect": connect, "group_ring_release": entry("release"),
             "group_ring_freed": lambda ring, slot: calls.append(("freed", slot)) or 0,
             "group_ring_send": entry("send"), "group_ring_wait": entry("wait"),
             "group_ring_disconnect": last("disconnect"), "group_ring_destroy": last("destroy")}
    return funcs, calls, stamps


def _ring_host_side(rank, mesh14):
    """GroupRing on the stand-in: EXCHANGES exchanges through the time=4 line's
    GroupAxis and its close, then a neighbour that cannot be opened (rank 2),
    then a launch that fails (a line of one rank), then rings on the line
    dropped without close(): every rank's (finalizer), and every rank's but
    the last (leak). Returns what each showed."""
    axis = mesh14.group.axes["time"]
    out, saved = {}, (halo._library, halo._slot_views, halo._raw_stream,
                      torch.distributed.batch_isend_irecv, halo.GroupRing.DISCONNECT_WAIT_S)

    def no_fallback(ops):
        raise AssertionError("the kernel halo fell back to batch_isend_irecv")

    solo = [torch.distributed.new_group([r]) for r in range(WORLD)]   # every rank, in order
    try:
        halo._slot_views = lambda ptr, slots, floats, shape, dtype, device: [
            torch.full(shape, float(ptr) + s, dtype=dtype) for s in range(slots)]
        halo._raw_stream = lambda index: 0
        torch.distributed.batch_isend_irecv = no_fallback
        funcs, calls, stamps = _fake_halo(rank)
        halo._library = lambda: funcs
        before = halo.LAUNCHES_GROUP
        tail = torch.zeros(2, 3).as_subclass(_OnCard)
        got = [axis.shift_from_left([tail], torch.ones(3), kernel=True)[0]
               for _ in range(EXCHANGES)]
        axis.close()
        out["protocol"] = (calls, halo.LAUNCHES_GROUP - before,
                           [float(g.flatten()[0]) for g in got])
        out["close"] = stamps
        funcs, calls, stamps = _fake_halo(rank, {"connect": 201} if rank == 2 else {})
        halo._library = lambda: funcs
        try:
            axis.shift_from_left([torch.zeros(5).as_subclass(_OnCard)], torch.ones(5),
                                 kernel=True)
            out["open"] = ("no error", calls)
        except RuntimeError as err:
            out["open"] = (str(err), calls)
        out["open_close"] = stamps
        funcs, calls, _ = _fake_halo(rank, {"send": 700})
        halo._library = lambda: funcs
        ring = halo.GroupRing([rank], 0, solo[rank], (4,), torch.float32, torch.device("cpu"))
        try:
            ring.shift(torch.zeros(4), torch.ones(4))
            out["launch"] = "no error"
        except RuntimeError as err:
            out["launch"] = str(err)
        ring.close()
        for case in ("finalizer", "leak"):
            funcs, calls, stamps = _fake_halo(rank)
            halo._library = lambda: funcs
            if case == "leak":
                halo.GroupRing.DISCONNECT_WAIT_S = LEAK_WAIT_S
            ring = halo.GroupRing(axis.ranks, axis.indices[0], axis.group, (3,), torch.float32,
                                  torch.device("cpu"))
            for _ in range(3):
                ring.shift(torch.zeros(3), torch.ones(3) if rank == 0 else None)
            kept = case == "leak" and rank == WORLD - 1   # never disconnects while the others wait
            time.sleep(STAGGER_S * rank)
            said = io.StringIO()
            with contextlib.redirect_stderr(said):
                if not kept:
                    del ring   # its finalizer, as at interpreter exit
                    gc.collect()
                torch.distributed.barrier(group=axis.group)
                if kept:
                    del ring
                    gc.collect()
            out[case] = (calls, stamps, said.getvalue())
    finally:
        (halo._library, halo._slot_views, halo._raw_stream,
         torch.distributed.batch_isend_irecv, halo.GroupRing.DISCONNECT_WAIT_S) = saved
    return out


def _rank(rank, rdv, streams, results):
    try:
        torch.set_num_threads(2)
        initialize_distributed(f"file://{rdv}", WORLD, rank, backend="gloo")
        try:
            make_global_mesh(channel=2, time=2, device="cuda:0")
            card = "no error"
        except RuntimeError as err:
            card = str(err)
        mesh = make_global_mesh(channel=2, time=2)
        got = _run(mesh)
        same = None
        if rank == 0:
            want = _run(make_mesh(channel=2, time=2, devices=[torch.device("cpu")] * 4))
            same = all(torch.equal(a, b) for k in want
                       for a, b in zip(_flat(got[k]), _flat(want[k])))
        mesh14, sharded = _time_sharded(rank, streams)
        ring = _ring_host_side(rank, mesh14)
        results.put((rank, dict(same=same, peak=float(got[("usb", "spectral")][0].abs().max()),
                                card=card, sharded=sharded, ring=ring), None))
        torch.distributed.destroy_process_group()
    except Exception:   # the parent reports it
        results.put((rank, None, traceback.format_exc()))


def _jax_chains(streams) -> dict:
    """JAX's time-sharded chains with the Pallas halo on 4 virtual CPU devices."""
    import jax.numpy as jnp

    from radiodsp_sdr_rx_tpu.models.config import AGCMode as JAGC
    from radiodsp_sdr_rx_tpu.models.config import DemodMode as JDemod
    from radiodsp_sdr_rx_tpu.models.config import ReceiverConfig as JConfig
    from radiodsp_sdr_rx_tpu.models.receiver import build_params as jax_build_params
    from radiodsp_sdr_rx_tpu.parallel import make_mesh as jax_make_mesh
    from radiodsp_sdr_rx_tpu.parallel.stream_shard import (
        make_time_sharded_ssb_chain as jax_chain)

    out = {}
    for mode in MODES:
        cfg = _config(mode)
        p = jax_build_params(JConfig(mode=JDemod[cfg.mode.name], agc=JAGC[cfg.agc.name],
                                     vfo_freq=cfg.vfo_freq,
                                     capture_center_freq=cfg.capture_center_freq,
                                     iq_gain_balance=cfg.iq_gain_balance))
        chain = jax_chain(jax_make_mesh(channel=1, time=4), sample_rate=FS, halo="pallas",
                          am=mode == "am")
        out[mode] = np.asarray(chain(jnp.asarray(streams[mode]), *_chain_args(p)))
    return out


@pytest.fixture(scope="module")
def spawned():
    """Every rank's results (rank -> dict) and the JAX chains' outputs."""
    streams = {mode: _stream(mode) for mode in MODES}
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank, args=(r, f"{tmp}/rdv", streams, results))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        got, alive = {}, []
        try:
            jax_out = _jax_chains(streams)
            for _ in range(WORLD):
                rank, res, err = results.get(timeout=JOIN_S)
                assert err is None, f"rank {rank} failed:\n{err}"
                got[rank] = res
        finally:
            for p in procs:
                p.join(timeout=10)
            alive = [p.pid for p in procs if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
    assert not alive, f"processes {alive} did not exit"
    return got, jax_out


def test_gloo_process_group_mesh_equals_in_process_mesh(spawned):
    got, _ = spawned
    assert got[0]["same"] is True, "the gloo mesh differs from the in-process mesh"
    assert len({r["peak"] for r in got.values()}) == 1 and got[0]["peak"] > 0


@pytest.mark.parametrize("mode", MODES)
def test_kernel_halo_on_the_gloo_cpu_mesh_is_the_plain_exchange(spawned, mode):
    """halo="kernel" on CPU shards of a process group runs the plain
    exchange: bit for bit the group's ppermute halo on every rank, and the
    in-process mesh's kernel halo."""
    got, _ = spawned
    assert all(r["sharded"][mode][0] is True for r in got.values())
    assert got[0]["sharded"][mode][1] is True


@pytest.mark.parametrize("mode", MODES)
def test_gloo_kernel_halo_chain_equals_jax_pallas_halo(spawned, mode):
    got, jax_out = spawned
    port = got[0]["sharded"][mode][2]
    assert port.shape == jax_out[mode].shape == (N_1D,) and np.isfinite(port).all()
    assert np.abs(port).max() > 0
    np.testing.assert_allclose(port, jax_out[mode], atol=TOL_JAX, rtol=0)


def test_make_global_mesh_takes_an_explicit_device(spawned):
    got, _ = spawned
    for rank, r in got.items():
        assert r["sharded"]["devices"] == ["cpu"] and r["sharded"]["coords"] == [(0, rank)]
        assert "no cuda:0 here" in r["card"] and "no CPU fallback" in r["card"]


def test_group_ring_host_protocol(spawned):
    """Exchange k writes slot k mod SLOTS: a rank with a left neighbour
    records the slot of exchange k + SLOTS - 2 free and checks that record,
    a rank with a right neighbour (or the
    line's first, which takes the stream-start carry) launches once, a rank
    with a left neighbour waits for its write; each rank opens its
    neighbours' handles."""
    got, _ = spawned
    for rank, r in got.items():
        calls, launched, firsts = r["ring"]["protocol"]
        left = rank - 1 if rank > 0 else None
        right = rank + 1 if rank < WORLD - 1 else None
        want = [("create", 6), ("connect", left, right)]
        slots = SLOTS
        for k in range(EXCHANGES):
            freed = (k + slots - 2) % slots
            want += [("release", freed), ("freed", freed)] * (left is not None)
            want += [("send", k % slots, rank == 0)] * (right is not None or rank == 0)
            want += [("wait", k % slots)] * (left is not None)
        want += [("disconnect",), ("destroy",)]   # GroupAxis.close
        assert calls == want, rank
        assert launched == (EXCHANGES if right is not None or rank == 0 else 0)
        assert firsts == [2000.0 + rank + k % slots for k in range(EXCHANGES)]   # exchange k's


def test_group_ring_raises_when_a_neighbour_cannot_be_opened(spawned):
    got, _ = spawned
    for rank, r in got.items():
        msg, calls = r["ring"]["open"]
        if rank == 2:
            assert "cannot open its neighbours' slots" in msg and "cudaError 201" in msg
        else:
            assert "1 rank(s) of the line could not open" in msg
        assert calls[-2:] == [("disconnect",), ("destroy",)]
        assert not any(c[0] == "send" for c in calls)


@pytest.mark.parametrize("case", ["close", "open_close"])
def test_group_ring_teardown_disconnects_every_rank_before_any_frees(spawned, case):
    """A line's rings are freed in two halves: every rank closes its
    mappings of its neighbours' slots and events, the line meets, and only
    then does any rank free its own (GroupAxis.close, and a ring whose
    neighbour could not be opened)."""
    got, _ = spawned
    stamps = [r["ring"][case] for r in got.values()]
    assert max(s["disconnect"] for s in stamps) < min(s["destroy"] for s in stamps)


def test_group_ring_finalizer_frees_only_after_every_rank_disconnects(spawned):
    """Fault F2: a ring dropped without close() (its finalizer, which also
    runs at interpreter exit, where the line cannot meet) closes its
    mappings, raises its flag, and frees its slots only once every rank of
    the line has raised its own. The ranks drop their ends STAGGER_S apart,
    so rank 0 frees only after rank 3, the last, disconnected."""
    got, _ = spawned
    stamps = [r["ring"]["finalizer"][1] for r in got.values()]
    assert max(s["disconnect"] for s in stamps) < min(s["destroy"] for s in stamps)
    assert min(s["destroy"] for s in stamps) - got[0]["ring"]["finalizer"][1]["disconnect"] > (
        2 * STAGGER_S)
    for r in got.values():
        calls, _, said = r["ring"]["finalizer"]
        assert calls[-2:] == [("disconnect",), ("destroy",)] and said == ""


def test_group_ring_finalizer_leaks_when_a_rank_never_disconnects(spawned):
    """Fault F2's other half: while the line's last rank keeps its ring,
    the others' finalizers wait LEAK_WAIT_S for its flag, then leak their
    slots and events (no destroy) and say so once on stderr; the last rank,
    dropping its ring after them, sees every flag up and frees."""
    got, _ = spawned
    for rank, r in got.items():
        calls, stamps, said = r["ring"]["leak"]
        if rank == WORLD - 1:
            assert calls[-2:] == [("disconnect",), ("destroy",)] and said == ""
        else:
            assert calls[-1] == ("disconnect",) and "destroy" not in stamps
            assert said.count("leaks its kernel-halo ring") == 1, said


def test_group_ring_result_lives_until_the_exchange_after_next(spawned):
    """A result kept over the 3 exchanges after it: the ring hands its slot
    back to the left neighbour (records it free) at the second of them, not
    before, as the contract on both axes' shift_from_left says; a caller
    that keeps a halo longer clones it."""
    got, _ = spawned
    for rank in range(1, WORLD):
        calls = got[rank]["ring"]["protocol"][0]
        releases = [c[1] for c in calls if c[0] == "release"]   # one an exchange
        assert len(releases) == EXCHANGES
        for k in range(EXCHANGES - 3):
            kept = k % SLOTS
            assert kept not in releases[k:k + 2] and releases[k + 2] == kept
    for doc in (collectives.GroupAxis.shift_from_left.__doc__,
                collectives.LocalAxis.shift_from_left.__doc__, halo.GroupRing.shift.__doc__):
        assert "exchange after next" in " ".join(doc.split())


def test_group_ring_raises_when_its_launch_fails(spawned):
    got, _ = spawned
    for r in got.values():
        assert "ring_shift launch across processes failed: cudaError 700" in r["ring"]["launch"]


def test_initialize_distributed_is_a_no_op_for_one_process():
    initialize_distributed(None, 1, 0)
    initialize_distributed()
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_global_mesh(channel=2, time=2)
