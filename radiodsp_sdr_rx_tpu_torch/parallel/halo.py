"""The ring halo exchange K9 (``radiodsp_sdr_rx_tpu/parallel/pallas_halo.py``).

``ring_shift_right(blocks)``: shard s receives shard s-1's block, shard 0 the
last shard's. ``shift_from_left_kernel(tails, first_tail)``: the same with
shard 0 taking ``first_tail``, the stream-start carry, in place of the wrap
(JAX ``shift_from_left_pallas``; ``parallel/stream_shard`` uses it for the
overlap-save halos with ``halo="kernel"``). ``blocks`` lists the shards of
one mesh line in this process, or of several lines one after another with
``ring`` shards each (``parallel/collectives.LocalAxis``), all of one shape
and dtype, f32 or complex64. Outputs are new tensors, each on its shard's
device.

CPU tensors run the plain versions (``*_plain``, list copies, which are also
the in-process mesh's ppermute halo). CUDA tensors launch ``csrc/halo.cu``
(``ring_shift``) or raise: on one card the whole exchange, every ring of
it, is one launch;
with shards on several cards, one launch per source card writing into its
neighbours' buffers by peer access (``cudaDeviceEnablePeerAccess``; raises
where the cards have no peer path), each destination's stream waiting on
its sender's event. ``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from radiodsp_sdr_rx_tpu_torch.utils import build

LAUNCHES = 0   # ring_shift
MAX_PAIRS = 64   # csrc/halo.cu kMaxPairs
_PEERS: set[tuple[int, int]] = set()


def _rings(n: int, ring: int | None) -> list[list[int]]:
    """The shard indices of each ring of ``ring`` consecutive shards (all n
    by default)."""
    ring = ring or n
    if ring < 1 or n % ring:
        raise ValueError(f"{n} blocks are no whole number of rings of {ring}")
    return [list(range(r, r + ring)) for r in range(0, n, ring)]


def _firsts(first_tail, n_rings: int):
    firsts = first_tail if isinstance(first_tail, (list, tuple)) else [first_tail] * n_rings
    if len(firsts) != n_rings:
        raise ValueError(f"{len(firsts)} first tails for {n_rings} rings")
    return firsts


def ring_shift_right_plain(blocks, ring: int | None = None):
    rings = _rings(len(blocks), ring)
    return [blocks[r[s - 1]].to(blocks[i].device, copy=True) for r in rings
            for s, i in enumerate(r)]


def shift_from_left_plain(tails, first_tail, ring: int | None = None):
    rings = _rings(len(tails), ring)
    out = []
    for r, first in zip(rings, _firsts(first_tail, len(rings))):
        t0 = tails[r[0]]
        out.append(first.to(device=t0.device, dtype=t0.dtype).expand_as(t0).clone())
        out += [tails[r[s - 1]].to(tails[i].device, copy=True) for s, i in enumerate(r) if s]
    return out


def _check(blocks):
    if not blocks:
        raise ValueError("the ring needs at least one shard")
    b0 = blocks[0]
    if b0.dtype not in (torch.float32, torch.complex64):
        raise ValueError(f"the ring moves f32 or complex64 blocks, got {b0.dtype}")
    for b in blocks:
        if b.shape != b0.shape or b.dtype != b0.dtype:
            raise ValueError(f"every block must be {b0.dtype} {tuple(b0.shape)}, got "
                             f"{b.dtype} {tuple(b.shape)}")
    kinds = {b.device.type for b in blocks}
    if len(kinds) > 1 or kinds - {"cpu", "cuda"}:
        raise ValueError(f"the ring runs on cuda or cpu tensors, all of one kind, got {kinds}")


def _library():
    """The built ``csrc/halo.cu`` with its two functions' signatures set."""
    lib = build.load_library("halo")
    if lib.ring_shift.argtypes is None:
        lib.ring_shift.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.ring_shift.restype = ctypes.c_int
        lib.enable_peer_access.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.enable_peer_access.restype = ctypes.c_int
    return lib


def _enable_peer(lib, src: int, dst: int) -> None:
    if src == dst or (src, dst) in _PEERS:
        return
    err = lib.enable_peer_access(src, dst)
    if err:
        raise RuntimeError(f"cuda:{src} cannot write into cuda:{dst} (peer access "
                           f"{'unsupported' if err == -1 else f'cudaError {err}'}); the "
                           "kernel halo needs peer access between the mesh's cards")
    _PEERS.add((src, dst))


def _launch(sources, outs):
    """Copy sources[s] -> outs[s]: one ring_shift launch per source device,
    on its current stream. Returns outs."""
    global LAUNCHES
    pairs = list(zip(sources, outs))
    lib = _library()
    if not all(src.is_contiguous() for src, _ in pairs):
        raise ValueError("ring_shift takes contiguous blocks")
    floats = pairs[0][0].numel() * (2 if pairs[0][0].is_complex() else 1)
    by_src: dict[int, list] = {}
    for src, dst in pairs:
        by_src.setdefault(src.device.index or 0, []).append((src, dst))
    for dev, group in by_src.items():
        if len(group) > MAX_PAIRS:
            raise ValueError(f"the ring kernel takes at most {MAX_PAIRS} shards a card")
        with torch.cuda.device(dev):   # the C side sets the device; this restores the caller's
            stream = torch.cuda.current_stream(dev)
            remote = {d.device.index or 0 for _, d in group} - {dev}
            for peer in remote:   # the buffers were made on the peer's stream
                _enable_peer(lib, dev, peer)
                stream.wait_stream(torch.cuda.current_stream(peer))
            srcs = (ctypes.c_void_p * len(group))(*(src.data_ptr() for src, _ in group))
            dsts = (ctypes.c_void_p * len(group))(*(dst.data_ptr() for _, dst in group))
            err = lib.ring_shift(srcs, dsts, len(group), floats, dev, stream.cuda_stream)
            if err:
                raise RuntimeError(f"ring_shift launch failed: "
                                   f"{'bad table' if err == -1 else f'cudaError {err}'}")
            LAUNCHES += 1
            for peer in remote:
                torch.cuda.current_stream(peer).wait_stream(stream)
    return outs


def ring_shift_right(blocks, ring: int | None = None):
    """Every shard receives its LEFT neighbour's block (shard 0 of a ring
    the ring's last one's). ``ring``: shards per ring, the list holding
    rings one after another (default: one ring of all). Returns new
    tensors, each on its shard's device."""
    _check(blocks)
    if blocks[0].device.type == "cpu":
        return ring_shift_right_plain(blocks, ring)
    rings = _rings(len(blocks), ring)
    return _launch([blocks[r[s - 1]] for r in rings for s in range(len(r))],
                 [torch.empty_like(b) for b in blocks])


def shift_from_left_kernel(tails, first_tail, ring: int | None = None):
    """Every shard receives its LEFT neighbour's tail; shard 0 of each ring
    receives ``first_tail`` (a tensor for every ring, or a list with one a
    ring), broadcast to the tails' shape."""
    _check(tails)
    if tails[0].device.type == "cpu":
        return shift_from_left_plain(tails, first_tail, ring)
    rings = _rings(len(tails), ring)
    sources = []
    for r, first in zip(rings, _firsts(first_tail, len(rings))):
        t0 = tails[r[0]]
        sources.append(first.to(device=t0.device, dtype=t0.dtype).expand_as(t0).contiguous())
        sources += [tails[r[s - 1]] for s in range(1, len(r))]
    return _launch(sources, [torch.empty_like(t) for t in tails])
