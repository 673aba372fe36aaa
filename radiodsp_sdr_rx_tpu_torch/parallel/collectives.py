"""Collectives over the shards of one mesh axis (no JAX module: these are
``jax.lax.ppermute``, ``all_gather``, ``psum``, ``all_to_all`` and
``axis_index`` inside ``shard_map``).

An axis object stands for the shards of one line of the mesh that this
process holds, and every collective takes and returns a list with one tensor
per such shard, in order. The sharded functions (``parallel/stream_shard.py``)
are written once against that interface:

  - ``LocalAxis``, the in-process mesh: the list holds every shard of the
    mesh's lines, each on its mesh device, line after line, and the stages
    run over the list in lockstep. Moving a tensor is ``Tensor.to``; the ppermute halo is the
    plain ring shift of ``parallel/halo.py``, whose kernel (K9) runs the
    same exchange in one launch.
  - ``GroupAxis``, the process-group mesh: the list holds this rank's one
    shard; ``shift_from_left`` is ``batch_isend_irecv``, or with ``kernel``
    on a card K9 across processes (``parallel/halo.GroupRing``, the ring
    cached on the axis), ``all_gather``, ``psum`` and ``all_to_all`` are
    ``all_gather``, ``all_reduce`` and ``all_to_all_single``,
    ``last_shard_value`` a broadcast from the line's last rank. Complex
    tensors cross as their real view and bools as bytes; gloo moves only
    CPU tensors for these, so on a gloo group a shard on a card crosses
    through host memory.

``shift_from_left``'s result on either axis is valid until the exchange
after next on that axis, read on the current stream: on a card, GroupAxis's
kernel route returns a view of a receive slot that the left neighbour
writes again later (``parallel/halo.GroupRing``). The other routes return
new memory, but a caller that keeps a halo longer clones it.

``indices`` holds each listed shard's coordinate on the axis
(``jax.lax.axis_index``) and ``size`` the axis length.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _wire(t: torch.Tensor, host: bool) -> torch.Tensor:
    """What crosses the wire for ``t``; in host memory with ``host``."""
    if t.is_complex():
        w = torch.view_as_real(t.contiguous())
    else:
        w = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    return w.cpu() if host else w


def _unwire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    w = w.to(like.device)
    if like.is_complex():
        return torch.view_as_complex(w.contiguous())
    return w.bool() if like.dtype == torch.bool else w


def _through_host(group) -> bool:
    """Whether ``group``'s collectives take only CPU tensors (gloo)."""
    return dist.get_backend(group) == "gloo"


def all_gather_tensor(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """(size, *x.shape): every rank's x, in rank order within ``group``."""
    w = _wire(x, _through_host(group))
    out = torch.empty((size,) + tuple(w.shape), dtype=w.dtype, device=w.device)
    dist.all_gather(list(out.unbind(0)), w, group=group)
    return _unwire(out, x)


class LocalAxis:
    """Every shard of one or more mesh lines, in this process: shard s on
    devices[s], the lines one after another, ``size`` shards each. Each
    collective acts within a line; the lines run in lockstep."""

    def __init__(self, devices, size: int | None = None):
        self.devices = list(devices)
        self.size = size or len(self.devices)
        if len(self.devices) % self.size:
            raise ValueError(f"{len(self.devices)} shards are no whole number of lines of "
                             f"{self.size}")
        self.indices = [s % self.size for s in range(len(self.devices))]

    def _lines(self, vals):
        return [vals[i:i + self.size] for i in range(0, len(vals), self.size)]

    def shift_from_left(self, tails, first_tail, kernel: bool = False):
        """Shard s receives shard s-1's tail, each line's first shard its
        ``first_tail`` (a tensor for every line, or the per-shard list of a
        replicated carry, whose line-first entries are taken); on the K9
        kernel with ``kernel``, else the plain copies. New tensors here,
        but the axes' contract is the weaker GroupAxis one: valid until the
        exchange after next."""
        from radiodsp_sdr_rx_tpu_torch.parallel import halo

        firsts = first_tail[::self.size] if isinstance(first_tail, list) else first_tail
        fn = halo.shift_from_left_kernel if kernel else halo.shift_from_left_plain
        return fn(tails, firsts, ring=self.size)

    def all_gather(self, vals):
        return [torch.stack([v.to(d) for v in line]) for line, devs in
                zip(self._lines(vals), self._lines(self.devices)) for d in devs]

    def psum(self, vals):
        out = []
        for line, devs in zip(self._lines(vals), self._lines(self.devices)):
            total = line[0]
            for v in line[1:]:
                total = total + v.to(total.device)
            out += [total.to(d) for d in devs]
        return out

    def all_to_all(self, vals, split_axis: int, concat_axis: int):
        """Tiled all_to_all: shard j of a line gets piece j of every shard's
        ``split_axis`` in the line, concatenated along ``concat_axis`` in
        shard order."""
        out = []
        for line, devs in zip(self._lines(vals), self._lines(self.devices)):
            parts = [v.tensor_split(self.size, dim=split_axis) for v in line]
            out += [torch.cat([p[j].to(d) for p in parts], dim=concat_axis)
                    for j, d in enumerate(devs)]
        return out

    def last_shard_value(self, vals):
        """Each line's last shard's value on every shard of the line (the
        stream's final carry)."""
        return [line[-1].to(d) for line, devs in
                zip(self._lines(vals), self._lines(self.devices)) for d in devs]


class GroupAxis:
    """This rank's shard of one mesh line whose shards are the processes
    ``ranks`` (global ranks, in axis order) of ``group``."""

    def __init__(self, ranks, group, index: int, device):
        self.ranks = list(ranks)
        self.group = group
        self.size = len(self.ranks)
        self.indices = [index]
        self.devices = [device]
        self.host = _through_host(group)
        self._rings: dict = {}

    def ring(self, like: torch.Tensor):
        """The K9 ring across this line's processes for blocks like ``like``
        (``parallel/halo.GroupRing``), built at the first exchange of its
        shape, dtype and device, and kept."""
        from radiodsp_sdr_rx_tpu_torch.parallel import halo

        key = (tuple(like.shape), like.dtype, like.device)
        if key not in self._rings:
            self._rings[key] = halo.GroupRing(self.ranks, self.indices[0], self.group, *key)
        return self._rings[key]

    def close(self) -> None:
        """Free the kernel halo's rings (every rank of the line together)."""
        from radiodsp_sdr_rx_tpu_torch.parallel import halo

        halo.close_rings(list(self._rings.values()), self.group)
        self._rings.clear()

    def shift_from_left(self, tails, first_tail, kernel: bool = False):
        """Rank s receives rank s-1's tail, the line's first rank
        ``first_tail``. With ``kernel``, a shard on a card goes through K9
        across processes (one launch a rank, no fallback); on the CPU, and
        without ``kernel``, the exchange is ``batch_isend_irecv``. K9's
        result is a view of a receive slot, valid until the exchange after
        next is issued, read on the current stream; a caller that keeps it
        longer clones it."""
        (t,), idx = tails, self.indices[0]
        if isinstance(first_tail, list):
            first_tail = first_tail[0]
        if kernel and t.is_cuda:
            first = (first_tail.to(device=t.device, dtype=t.dtype).expand_as(t).contiguous()
                     if idx == 0 else None)
            return [self.ring(t).shift(t.contiguous(), first)]
        w = _wire(t, self.host)
        recv = torch.empty_like(w)
        ops = []
        if idx + 1 < self.size:
            ops.append(dist.P2POp(dist.isend, w, self.ranks[idx + 1], self.group))
        if idx > 0:
            ops.append(dist.P2POp(dist.irecv, recv, self.ranks[idx - 1], self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if idx == 0:
            return [first_tail.to(t.device).expand_as(t)]
        return [_unwire(recv, t)]

    def all_gather(self, vals):
        return [all_gather_tensor(vals[0], self.group, self.size)]

    def psum(self, vals):
        w = _wire(vals[0], self.host).clone()
        dist.all_reduce(w, group=self.group)
        return [_unwire(w, vals[0])]

    def all_to_all(self, vals, split_axis: int, concat_axis: int):
        v = vals[0]
        w = _wire(v.movedim(split_axis, 0), self.host)
        out = torch.empty_like(w)
        dist.all_to_all_single(out, w, group=self.group)
        got = _unwire(out, v).tensor_split(self.size, dim=0)
        return [torch.cat([p.movedim(0, split_axis) for p in got], dim=concat_axis)]

    def last_shard_value(self, vals):
        w = _wire(vals[0], self.host).clone()
        dist.broadcast(w, src=self.ranks[-1], group=self.group)
        return [_unwire(w, vals[0])]
