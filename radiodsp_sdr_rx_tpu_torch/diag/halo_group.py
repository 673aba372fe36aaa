"""What an exchange of K9 across processes (``parallel/halo.GroupRing``)
spends its time on, with every rank of a gloo group on one CUDA card:
a chain of 100 exchanges of (128, 128) complex64 blocks on groups of 2 and
then 4 spawned ranks, each variant timed by the host's clock on every rank
(the slowest printed), the variants in turns:

  shipped    the ring as it is: the slot-free record and its check, the
             right neighbour's flag, the launch into its slot, the written
             record and flag, the left neighbour's flag and the stream's wait
             on its written event;
  local      the same flags, and one launch a rank of ``ring_shift``
             copying its tail into a buffer of its own: no event crosses a
             process, so what is left is the contexts taking turns on the
             card;
  handshake  the same flags with every CUDA entry a no-op: the host's part;
  nowait     shipped without the stream's wait on the written event.

Only ``shipped`` computes the exchange. Every process is joined with a
timeout.

    python -m radiodsp_sdr_rx_tpu_torch.diag.halo_group [--ranks 2,4]
"""

from __future__ import annotations

import argparse
import multiprocessing
import struct
import tempfile
import time
import traceback

EXCHANGES = 100
BLOCK = (128, 128)
VARIANTS = ("shipped", "local", "handshake", "nowait") * 2
JOIN_S = 240


def _rank(rank: int, world: int, rdv: str, results) -> None:
    try:
        import torch
        import torch.distributed as dist

        from radiodsp_sdr_rx_tpu_torch.parallel import (
            halo, initialize_distributed, make_global_mesh)

        torch.set_num_threads(2)
        torch.cuda.set_device(0)
        initialize_distributed(f"file://{rdv}", world, rank, backend="gloo")
        mesh = make_global_mesh(channel=1, time=world, device="cuda:0")
        axis = mesh.group.axes["time"]
        x0 = torch.randn(BLOCK, device="cuda", dtype=torch.complex64)
        first = torch.zeros_like(x0)
        ring = axis.ring(x0)
        real = ring._lib
        local = torch.empty_like(x0)

        def local_send(ring_ptr, slot, tail, first_ptr, stream):
            return real["ring_shift"](struct.pack("Q", tail), struct.pack("Q", local.data_ptr()),
                                      1, 2 * x0.numel(), 0, stream)

        libs = {"shipped": real,
                "nowait": {**real, "group_ring_wait": lambda *a: 0},
                "local": {**{k: (lambda *a: 0) for k in real}, "group_ring_send": local_send},
                "handshake": {k: (lambda *a: 0) for k in real}}
        out = {v: [] for v in VARIANTS}
        for variant in ("shipped",) + VARIANTS:   # the first round warms
            ring._lib = libs[variant]
            x = x0
            dist.barrier(group=axis.group)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(EXCHANGES):
                x = axis.shift_from_left([x], first, kernel=True)[0]
                if variant != "shipped":
                    x = x0
            torch.cuda.synchronize()
            out[variant].append((time.perf_counter() - t) / EXCHANGES * 1e6)
        ring._lib = real
        for v in out:
            out[v] = out[v][1:] if v == "shipped" else out[v]
        mesh.close()
        results.put((rank, out, None))
        dist.destroy_process_group()
    except Exception:   # the parent reports it
        results.put((rank, None, traceback.format_exc()))


def run(world: int) -> dict:
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank, args=(r, world, f"{tmp}/rdv", results))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            for _ in range(world):
                rank, res, err = results.get(timeout=JOIN_S)
                if err:
                    raise RuntimeError(f"rank {rank}:\n{err}")
                got[rank] = res
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
    return got


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", default="2,4")
    for world in (int(w) for w in parser.parse_args().ranks.split(",")):
        got = run(world)
        print(f"{world} ranks on cuda:0, us per exchange, the slowest rank, in turns: "
              + "; ".join(f"{v} " + ", ".join(
                  f"{max(got[r][v][i] for r in got):.1f}" for i in range(len(got[0][v])))
                  for v in dict.fromkeys(VARIANTS)), flush=True)


if __name__ == "__main__":
    main()
