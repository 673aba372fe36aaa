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
or raise: on one card the whole exchange, every ring of it, is one launch
of ``ring_shift`` into one new allocation, handed back as per-shard views;
with shards on several cards, one launch per source card writing into its neighbours' buffers by peer access
(``cudaDeviceEnablePeerAccess``; raises where the cards have no peer path),
each destination's stream waiting on its sender's. ``LAUNCHES`` counts the
launches.

``GroupRing`` is the same kernel across processes, one shard a rank of a
process-group mesh line (``parallel/collectives.GroupAxis``): each rank
writes its tail straight into its right neighbour's receive slot through
CUDA IPC, one launch a rank and exchange. Its result is a view of a slot
that is written again later, valid until the exchange after next (see
``GroupRing``). ``LAUNCHES_GROUP`` counts its launches; ``close_rings``
frees a line's rings, every rank together.
"""

from __future__ import annotations

import collections
import ctypes
import mmap
import os
import struct
import sys
import tempfile
import time
import weakref

import torch
import torch.distributed as dist

from radiodsp_sdr_rx_tpu_torch.utils import build
from radiodsp_sdr_rx_tpu_torch.utils.profiling import span

LAUNCHES = 0         # ring_shift, in one process
LAUNCHES_GROUP = 0   # ring_shift_kernel through group_ring_send, across processes
MAX_PAIRS = 64       # csrc/halo.cu kMaxPairs
_PEERS: set[tuple[int, int]] = set()
_FUNCS: dict[str, object] = {}


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


def _check(blocks) -> tuple[bool, bool]:
    """Raise unless the blocks are one shape and dtype (f32 or complex64),
    all on the CPU or all on cards (and then contiguous). Returns (on
    cards, all on one device)."""
    if not blocks:
        raise ValueError("the ring needs at least one shard")
    b0 = blocks[0]
    shape, dtype, cuda, dev = b0.shape, b0.dtype, b0.is_cuda, b0.get_device()
    if dtype not in (torch.float32, torch.complex64):
        raise ValueError(f"the ring moves f32 or complex64 blocks, got {dtype}")
    one = True
    for b in blocks:
        if b.shape != shape or b.dtype != dtype:
            raise ValueError(f"every block must be {dtype} {tuple(shape)}, got "
                             f"{b.dtype} {tuple(b.shape)}")
        if b.is_cuda != cuda or not (cuda or b.is_cpu):
            kinds = {x.device.type for x in blocks}
            raise ValueError(f"the ring runs on cuda or cpu tensors, all of one kind, got {kinds}")
        if cuda and not b.is_contiguous():
            raise ValueError("ring_shift takes contiguous blocks")
        one = one and b.get_device() == dev
    return cuda, one


def _floats(t: torch.Tensor) -> int:
    return t.numel() * (2 if t.is_complex() else 1)


def _library():
    """The built ``csrc/halo.cu``, every function's signature set once."""
    if _FUNCS:
        return _FUNCS
    lib = build.load_library("halo")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    table = ctypes.c_char_p   # a struct-packed table of pointers
    signatures = {
        "ring_shift": [table, table, i32, i64, i32, ptr],
        "enable_peer_access": [i32, i32],
        "group_ring_handles_size": [],
        "group_ring_slots": [],
        "group_ring_create": [i32, i64, ctypes.POINTER(ptr), ctypes.POINTER(ptr), ptr],
        "group_ring_connect": [ptr, ptr, ptr],
        "group_ring_release": [ptr, i32, ptr],
        "group_ring_freed": [ptr, i32],
        "group_ring_send": [ptr, i32, ptr, ptr, ptr],
        "group_ring_wait": [ptr, i32, ptr],
        "group_ring_disconnect": [ptr],
        "group_ring_destroy": [ptr],
    }
    funcs = {}
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = None if name in ("group_ring_disconnect", "group_ring_destroy") else i32
        funcs[name] = fn
    _FUNCS.update(funcs)
    return _FUNCS


def _raw_stream(index: int) -> int:
    """The current stream of card ``index``, as the C entries take it."""
    return torch._C._cuda_getCurrentRawStream(index)


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: "
                           f"{'bad table' if err == -1 else f'cudaError {err}'}")


def _enable_peer(src: int, dst: int) -> None:
    if src == dst or (src, dst) in _PEERS:
        return
    err = _library()["enable_peer_access"](src, dst)
    if err:
        raise RuntimeError(f"cuda:{src} cannot write into cuda:{dst} (peer access "
                           f"{'unsupported' if err == -1 else f'cudaError {err}'}); the "
                           "kernel halo needs peer access between the mesh's cards")
    _PEERS.add((src, dst))


def _table(ptrs) -> bytes:
    return struct.pack(f"{len(ptrs)}Q", *ptrs)


def _launch(sources, like, one_device: bool):
    """sources[s] (contiguous, on the device of like[s]) -> a new block for
    shard s: one launch per source device, on its current stream."""
    global LAUNCHES
    b0, n = like[0], len(sources)
    floats = _floats(b0)
    if one_device:
        if n > MAX_PAIRS:
            raise ValueError(f"the ring kernel takes at most {MAX_PAIRS} shards a card")
        dev = b0.get_device()
        out = torch.empty((n,) + tuple(b0.shape), dtype=b0.dtype, device=b0.device)
        base, size = out.data_ptr(), floats * 4
        src_table, dst_table = (_table([s.data_ptr() for s in sources]),
                                _table([base + p * size for p in range(n)]))
        fn, stream = _library()["ring_shift"], _raw_stream(dev)
        with span("rdsp.launch", kernel="ring_shift"):
            err = fn(src_table, dst_table, n, floats, dev, stream)
        _raise_on(err, "ring_shift launch")
        LAUNCHES += 1
        return list(out.unbind(0))
    outs = [torch.empty_like(b) for b in like]
    by_src: dict[int, list] = {}
    for src, dst in zip(sources, outs):
        by_src.setdefault(src.get_device(), []).append((src, dst))
    for dev, pairs in by_src.items():
        if len(pairs) > MAX_PAIRS:
            raise ValueError(f"the ring kernel takes at most {MAX_PAIRS} shards a card")
        stream = torch.cuda.current_stream(dev)
        remote = {d.get_device() for _, d in pairs} - {dev}
        for peer in remote:   # the buffers were made on the peer's stream
            _enable_peer(dev, peer)
            stream.wait_stream(torch.cuda.current_stream(peer))
        src_table, dst_table = (_table([src.data_ptr() for src, _ in pairs]),
                                _table([dst.data_ptr() for _, dst in pairs]))
        fn = _library()["ring_shift"]
        with span("rdsp.launch", kernel="ring_shift"):
            err = fn(src_table, dst_table, len(pairs), floats, dev, stream.cuda_stream)
        _raise_on(err, "ring_shift launch")
        LAUNCHES += 1
        for peer in remote:
            torch.cuda.current_stream(peer).wait_stream(stream)
    return outs


def ring_shift_right(blocks, ring: int | None = None):
    """Every shard receives its LEFT neighbour's block (shard 0 of a ring
    the ring's last one's). ``ring``: shards per ring, the list holding
    rings one after another (default: one ring of all). Returns new
    tensors, each on its shard's device."""
    cuda, one = _check(blocks)
    if not cuda:
        return ring_shift_right_plain(blocks, ring)
    rings = _rings(len(blocks), ring)
    return _launch([blocks[r[s - 1]] for r in rings for s in range(len(r))], blocks, one)


def shift_from_left_kernel(tails, first_tail, ring: int | None = None):
    """Every shard receives its LEFT neighbour's tail; shard 0 of each ring
    receives ``first_tail`` (a tensor for every ring, or a list with one a
    ring), broadcast to the tails' shape."""
    cuda, one = _check(tails)
    if not cuda:
        return shift_from_left_plain(tails, first_tail, ring)
    rings = _rings(len(tails), ring)
    sources = []
    for r, first in zip(rings, _firsts(first_tail, len(rings))):
        t0 = tails[r[0]]
        sources.append(first.to(device=t0.device, dtype=t0.dtype).expand_as(t0).contiguous())
        sources += [tails[r[s - 1]] for s in range(1, len(r))]
    return _launch(sources, tails, one)


class GroupRing:
    """K9 across processes: this rank's end of a ring over one process-group
    mesh line, for blocks of one shape and dtype on one card.

    Built collectively (every rank of the line, in the same order): each rank
    allocates its receive slots (``group_ring_slots``) and their events in
    ``csrc/halo.cu``; the line's first rank makes a file of flags in the
    temporary directory; the line all-gathers the IPC handles and the file's
    path as bytes over ``group`` (in host memory under gloo, on the card
    under NCCL), maps the file, and each rank opens its left neighbour's
    written events and its right neighbour's slots. A rank that cannot makes
    every rank raise (CUDA IPC needs the line on one host).

    Exchange k writes slot k mod ``slots`` on every rank; each ``shift`` is
    one launch on a rank with a right neighbour or a ``first`` block (none
    on a line's last rank). Each rank has two counters in the mapped file,
    which its neighbours poll on the host (no kernel waits on a flag): slots
    written, raised once the interprocess event recorded after its launch is
    issued, so the right neighbour's stream can wait for it; and slots
    freed: at its exchange k a rank records the slot of exchange k + slots -
    2 free on its stream (its last use, exchange k - 2's result, is behind
    it) and raises the counter once that record is done, which it checks
    whenever it polls, so the left neighbour writes only into a slot it has
    seen freed, slots - 2 exchanges ahead of the write (the contexts on one
    card take turns, and a record is seen done in another context only
    after a turn).

    The lifetime of a result: ``shift`` returns a view of this rank's slot,
    not new memory. The result of exchange k is valid through exchange k + 1
    and until exchange k + 2 is issued, read on the current stream: exchange
    k + 2 hands its slot back to the left neighbour, which may then write it.
    A caller that keeps a result longer, or reads it on another stream,
    clones it first.

    ``close_rings`` frees a line's rings, every rank together; ``close`` (also
    run when the ring is collected or the process exits, where the line
    cannot meet) frees this rank's end alone: it closes its mappings, raises
    its disconnected flag, and frees its slots and events only once every
    rank of the line has raised its own (``_Teardown``), or leaks them after
    ``DISCONNECT_WAIT_S`` seconds and says so on stderr.
    """

    WAIT_S = 120.0   # a neighbour's flag waited for longer than this raises
    DISCONNECT_WAIT_S = 5.0   # a rank freeing alone waits this long for the line's disconnects

    def __init__(self, ranks, index: int, group, shape, dtype, device):
        if dtype not in (torch.float32, torch.complex64):
            raise ValueError(f"the ring moves f32 or complex64 blocks, got {dtype}")
        self.shape, self.dtype, self.device = tuple(shape), dtype, torch.device(device)
        self.index = self.device.index if self.device.index is not None else 0
        self.rank, self.position, self.group = ranks[index], index, group
        # where the line's collectives take their tensors
        self.wire = torch.device("cpu") if dist.get_backend(group) == "gloo" else self.device
        self.left = ranks[index - 1] if index > 0 else None
        self.right = ranks[index + 1] if index + 1 < len(ranks) else None
        self.count = 0
        self._flags = None
        # (counter, slot) of the releases not yet seen done
        self._pending: collections.deque[tuple[int, int]] = collections.deque()
        lib = self._lib = _library()
        self.slots = lib["group_ring_slots"]()
        numel = 1
        for n in self.shape:
            numel *= n
        floats = numel * (2 if dtype == torch.complex64 else 1)
        ring, slots = ctypes.c_void_p(), ctypes.c_void_p()
        size = lib["group_ring_handles_size"]()
        handles = ctypes.create_string_buffer(size)
        # a failure is only raised after the collectives below, which every
        # rank of the line must enter
        err = lib["group_ring_create"](self.index, floats, ctypes.byref(ring),
                                       ctypes.byref(slots), handles)
        what = f"cannot allocate its slots and events on cuda:{self.index} (cudaError {err})"
        self._ring = ring.value
        # the teardown holds no reference to the ring, so that the ring can
        # be collected; it takes the flags once they are mapped
        self._teardown = _Teardown(lib, self._ring, index, self.rank, self.DISCONNECT_WAIT_S)
        self._finalizer = weakref.finalize(self, self._teardown)
        path = ""
        if index == 0 and not err:
            try:
                path = _flag_file(len(ranks))
            except OSError as exc:
                err, what = -2, f"cannot make the line's flag file ({exc})"
        mine = torch.frombuffer(bytearray(handles.raw + path.encode().ljust(_PATH_BYTES, b"\0")),
                                dtype=torch.uint8).to(self.wire)
        every = [torch.empty_like(mine) for _ in ranks]
        dist.all_gather(every, mine, group=group)
        every = [e.cpu() for e in every]
        if not err:
            left = bytes(every[index - 1][:size].numpy()) if self.left is not None else None
            right = bytes(every[index + 1][:size].numpy()) if self.right is not None else None
            err = lib["group_ring_connect"](self._ring, left, right)
            what = f"cannot open its neighbours' slots and events (cudaError {err})"
        if not err:
            try:
                self._flags = self._teardown.flags = _Flags(
                    bytes(every[0][size:].numpy()).rstrip(b"\0").decode(), len(ranks))
            except (OSError, UnicodeDecodeError) as exc:
                err, what = -2, f"cannot map the line's flag file ({exc})"
        failed = _line_sum(1 if err else 0, group, self.wire)   # every rank mapped or failed
        if path:
            os.unlink(path)
        if failed:
            close_rings([self], group)
            raise RuntimeError(
                f"the kernel halo across processes: rank {self.rank} "
                + (what if err else f"stops: {failed} rank(s) of the line could not open "
                                    "their neighbours' slots")
                + "; CUDA IPC needs every rank of the line on one host")
        self.views = _slot_views(slots.value, self.slots, floats, self.shape, dtype,
                                 self.device)

    def _publish(self) -> None:
        """Raise this rank's freed counter past every release that is done."""
        while self._pending:
            k, slot = self._pending[0]
            err = self._lib["group_ring_freed"](self._ring, slot)
            if err == _NOT_READY:
                return
            _raise_on(err, "checking a slot free")
            self._pending.popleft()
            self._flags[2 * self.position] = k

    def _await(self, flag: int, k: int, what: str) -> None:
        """Poll the flag at ``flag`` until it reaches k, and this rank's own
        releases meanwhile."""
        flags, spins, start = self._flags, 0, None
        while flags[flag] < k:
            self._publish()
            spins += 1
            if spins % 4096 == 0:
                start = start or time.monotonic()
                if time.monotonic() - start > self.WAIT_S:
                    raise RuntimeError(f"the kernel halo across processes: rank {self.rank} "
                                       f"waited {self.WAIT_S:g} s for {what} of exchange {k}")
                os.sched_yield()

    def shift(self, tail: torch.Tensor, first: torch.Tensor | None = None) -> torch.Tensor:
        """This rank's received block: the left neighbour's ``tail``, or
        ``first`` (a block of the tail's shape, contiguous; the line's first
        rank) copied into this rank's slot. Every rank of the line calls it
        once an exchange. The result is a view of a slot, valid until the
        exchange after next is issued (see the class)."""
        global LAUNCHES_GROUP
        if self._finalizer is None:
            raise RuntimeError("the ring is closed")
        for t in (tail, first):
            if t is not None and (t.device != self.device or t.dtype != self.dtype
                                  or tuple(t.shape) != self.shape or not t.is_contiguous()):
                raise ValueError(f"the ring moves contiguous {self.dtype} {self.shape} blocks "
                                 f"on {self.device}, got {t.dtype} {tuple(t.shape)} on "
                                 f"{t.device}")
        lib, flags, me, slots = self._lib, self._flags, 2 * self.position, self.slots
        k = self.count
        slot, stream = k % slots, _raw_stream(self.index)
        if self.left is not None:   # the slot of exchange k + slots - 2, last read before k
            freed = (k + slots - 2) % slots
            _raise_on(lib["group_ring_release"](self._ring, freed, stream), "recording a slot free")
            self._pending.append((k + 1, freed))
            self._publish()
        if self.right is not None:   # freed by the right neighbour at its exchange k - slots + 2
            self._await(me + 2, k - slots + 3, "the right neighbour's slot")
        if self.right is not None or first is not None:
            with span("rdsp.launch", kernel="ring_shift_group"):
                err = lib["group_ring_send"](self._ring, slot, tail.data_ptr(),
                                             None if first is None else first.data_ptr(), stream)
            _raise_on(err, "ring_shift launch across processes")
            LAUNCHES_GROUP += 1
        if self.right is not None:
            flags[me + 1] = k + 1
        if self.left is not None:
            self._await(me - 1, k + 1, "the left neighbour's write")
            _raise_on(lib["group_ring_wait"](self._ring, slot, stream), "waiting for a write")
        self.count = k + 1
        return self.views[slot]

    def disconnect(self) -> None:
        """Close the neighbours' handles and raise this rank's disconnected
        flag: the first half of ``close_rings``."""
        if self._finalizer is not None:
            self._teardown.disconnect()

    def close(self) -> None:
        """Close the neighbours' handles, free the slots and events. Alone
        (not in ``close_rings``), it frees them once every rank of the line
        has disconnected, or leaks them after ``DISCONNECT_WAIT_S``."""
        if self._finalizer is not None:
            self._finalizer()
            self._finalizer = None
        self._flags = None


def _line_sum(value: int, group, wire: torch.device) -> int:
    """The sum of ``value`` over ``group``'s ranks, on the host of every rank
    once all have entered (a barrier that also carries a count)."""
    t = torch.tensor([value], dtype=torch.int64, device=wire)
    dist.all_reduce(t, group=group)
    return int(t.item())


def close_rings(rings, group) -> None:
    """Free rings of one line, every rank of ``group`` together with its
    rings in the same order: each rank finishes its work on the card and
    closes its mappings of its neighbours' slots and events, the line meets,
    and only then does each free its own (an allocation another process
    still maps is not freed)."""
    if not rings:
        return
    if rings[0].device.type == "cuda":
        torch.cuda.synchronize(rings[0].device)   # every write into a neighbour is done
    for ring in rings:
        ring.disconnect()
    _line_sum(0, group, rings[0].wire)
    for ring in rings:
        ring._teardown.met = True   # every rank disconnected: no flag to wait for
        ring.close()


class _Teardown:
    """The end of one rank's ring, run once, by ``close`` or by the ring's
    finalizer (collection, interpreter exit). It closes this rank's mappings
    of its neighbours' slots and events and raises its disconnected flag in
    the line's flag file. It frees the slots and events once the line has met
    after every rank disconnected (``close_rings`` sets ``met``) or every
    rank's flag is up, polled for at most ``wait_s`` seconds: the left
    neighbour maps this rank's slots and the right one its events, and a
    cudaFree of an exported allocation that another process still maps is
    undefined. Past the wait it leaks them and says so on stderr; they go
    with this process's CUDA context. It holds no reference to the ring."""

    def __init__(self, lib, ring: int, position: int, rank: int, wait_s: float):
        self.lib, self.ring, self.position, self.rank = lib, ring, position, rank
        self.wait_s = wait_s
        self.flags: _Flags | None = None
        self.met = False
        self.disconnected = False

    def disconnect(self) -> None:
        if not self.disconnected:
            self.lib["group_ring_disconnect"](self.ring)
            self.disconnected = True
            if self.flags is not None:
                self.flags[self.flags.disconnected(self.position)] = 1

    def _line_disconnected(self) -> bool:
        flags = self.flags
        if flags is None:
            return False
        deadline = time.monotonic() + self.wait_s
        while not all(flags[flags.disconnected(p)] for p in range(flags.ranks)):
            if time.monotonic() > deadline:
                return False
            time.sleep(0.001)
        return True

    def __call__(self) -> None:
        self.disconnect()
        if self.met or self._line_disconnected():
            self.lib["group_ring_destroy"](self.ring)
        else:
            print(f"radiodsp_sdr_rx_tpu_torch: rank {self.rank} leaks its kernel-halo ring's "
                  f"slots and events: not every rank of the line closed its mappings within "
                  f"{self.wait_s:g} s", file=sys.stderr, flush=True)
        if self.flags is not None:
            self.flags.release()
            self.flags = None


_PATH_BYTES = 512   # the flag file's path, as the line's first rank sends it
_NOT_READY = 600    # cudaErrorNotReady
_FLAG_STRIDE = 8    # int64s between two flags: one cache line each
_FLAGS_A_RANK = 3   # slots freed, slots written, disconnected


def _flag_file(ranks: int) -> str:
    """A new file of zeroed flags for a line of ``ranks``, in the temporary
    directory; its path."""
    fd, path = tempfile.mkstemp(prefix="radiodsp_k9_")
    try:
        os.ftruncate(fd, _FLAGS_A_RANK * ranks * _FLAG_STRIDE * 8)
    finally:
        os.close(fd)
    return path


class _Flags:
    """The line's flags, mapped: ``flags[2 p]`` is position p's slots freed,
    ``flags[2 p + 1]`` its slots written (counts of exchanges), and
    ``flags[disconnected(p)]`` 1 once it closed its mappings of its
    neighbours' slots and events; each on a cache line of its own. Aligned
    8-byte loads and stores, which the host makes whole."""

    def __init__(self, path: str, ranks: int):
        self.ranks = ranks
        fd = os.open(path, os.O_RDWR)
        try:
            self._map = mmap.mmap(fd, _FLAGS_A_RANK * ranks * _FLAG_STRIDE * 8)
        finally:
            os.close(fd)
        self._view = memoryview(self._map).cast("q")

    def disconnected(self, position: int) -> int:
        return 2 * self.ranks + position

    def __getitem__(self, i: int) -> int:
        return self._view[i * _FLAG_STRIDE]

    def __setitem__(self, i: int, value: int) -> None:
        self._view[i * _FLAG_STRIDE] = value

    def release(self) -> None:
        self._view.release()
        self._map.close()


def _slot_views(ptr: int, slots: int, floats: int, shape, dtype, device) -> list[torch.Tensor]:
    """The ``slots`` receive slots at ``ptr`` (memory ``csrc/halo.cu``
    allocated) as tensors of ``shape``, through the CUDA array interface."""

    class _Slots:
        __cuda_array_interface__ = {"shape": (slots, floats), "typestr": "<f4",
                                    "data": (ptr, False), "version": 2}

    flat = torch.as_tensor(_Slots(), device=device)
    if dtype == torch.complex64:
        flat = flat.view(torch.complex64)
    return [s.view(shape) for s in flat.unbind(0)]
