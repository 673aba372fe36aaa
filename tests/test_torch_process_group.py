"""The port's sharded chain over a process group (gloo, CPU) equals the
in-process mesh bit for bit.

One spawn of four processes joins a gloo group (a file rendezvous under the
test's tmp_path, so parallel test workers do not collide on a port) and
builds ``make_global_mesh(channel=2, time=2)``: one shard per rank, the
halos ``batch_isend_irecv``, the gathers ``all_gather``, the adaptive
re-layout ``all_to_all_single``. Each rank runs USB/off, AM/notch and
USB/spectral through ``make_full_sharded_chain`` over two threaded segments
and gets the global result; rank 0 also runs the same on an in-process
channel=2 x time=2 mesh, and every rank's output and state must equal it
bit for bit (the same shard-local arithmetic; the collectives only move
values). ``halo="kernel"`` must raise on the process-group mesh: the kernel
writes into a neighbour's memory, which another process's is not. Every
process is joined with a timeout and the test fails if one is left alive.
"""

import multiprocessing as mp
import traceback

import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu_torch.models.config import AGCMode, DemodMode, ReceiverConfig
from radiodsp_sdr_rx_tpu_torch.models.receiver import build_params
from radiodsp_sdr_rx_tpu_torch.parallel import (
    initialize_distributed, make_global_mesh, make_mesh, make_time_sharded_ssb_chain)
from radiodsp_sdr_rx_tpu_torch.parallel.stream_shard import (
    make_full_sharded_chain, sharded_chain_init)

WORLD, C, N = 4, 8, 1024
COMBOS = [("usb", "off"), ("am", "notch"), ("usb", "spectral")]
JOIN_S = 150


def _args():
    p = build_params(ReceiverConfig(mode=DemodMode.USB, agc=AGCMode.FAST, vfo_freq=7_200_000.0,
                                    capture_center_freq=7_190_000.0, iq_gain_balance=1.0))
    return (p.w_sideband, p.w_audio, p.agc_release, p.agc_target, p.agc_max_gain,
            p.agc_enabled, p.output_gain)


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


def _rank(rank, rdv, results):
    try:
        torch.set_num_threads(2)
        initialize_distributed(f"file://{rdv}", WORLD, rank, backend="gloo")
        mesh = make_global_mesh(channel=2, time=2)
        got = _run(mesh)
        try:
            make_time_sharded_ssb_chain(mesh, halo="kernel")(np.zeros(4 * 256, np.complex64),
                                                             0, *_args()[:2], *_args()[2:5],
                                                             _args()[6])
            raised = "no error"
        except ValueError as err:
            raised = str(err)
        same = None
        if rank == 0:
            want = _run(make_mesh(channel=2, time=2, devices=[torch.device("cpu")] * 4))
            same = all(torch.equal(a, b) for k in want
                       for a, b in zip(_flat(got[k]), _flat(want[k])))
        results.put((rank, same, raised, float(got[("usb", "spectral")][0].abs().max()), None))
        torch.distributed.destroy_process_group()
    except Exception:   # the parent reports it
        results.put((rank, None, None, None, traceback.format_exc()))


def test_gloo_process_group_mesh_equals_in_process_mesh(tmp_path):
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, tmp_path / "rdv", results)) for r in range(WORLD)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(WORLD):
            rank, same, raised, peak, err = results.get(timeout=JOIN_S)
            assert err is None, f"rank {rank} failed:\n{err}"
            got[rank] = (same, raised, peak)
    finally:
        for p in procs:
            p.join(timeout=10)
        alive = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
    assert not alive, f"processes {alive} did not exit"
    assert got[0][0] is True, "the gloo mesh differs from the in-process mesh"
    assert all(raised and "process-group mesh" in raised for _, raised, _ in got.values())
    assert len({peak for _, _, peak in got.values()}) == 1 and got[0][2] > 0


def test_initialize_distributed_is_a_no_op_for_one_process():
    initialize_distributed(None, 1, 0)
    initialize_distributed()
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_global_mesh(channel=2, time=2)
