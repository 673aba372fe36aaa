"""A (channel, time) grid of devices, the port's ``jax.sharding.Mesh``
(``radiodsp_sdr_rx_tpu/parallel/mesh.py``).

Two kinds of mesh run the same sharded functions (``parallel/collectives.py``
gives each its collectives):

  - in one process, ``make_mesh``: the grid names ``torch.device``s, and a
    device may appear more than once, the counterpart of JAX's virtual CPU
    devices. The tests build one over ``[torch.device("cpu")] * 8``;
    ``chip_smoke.py`` over ``[torch.device("cuda:0")] * n``, where every
    shard is a tensor of its own on the one card.
  - over a process group, ``make_global_mesh``: one shard per rank, rank r
    at (r // time, r % time), after ``initialize_distributed`` (NCCL for
    CUDA, gloo for the CPU; gloo ranks may also share a card, with
    ``device="cuda:0"``).

``Mesh.shard`` and ``Mesh.unshard`` cut a global tensor into the pieces a
partition spec names and put them back, as ``shard_map``'s in_specs and
out_specs do; a spec maps a mesh axis name to the tensor dimension it splits.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from radiodsp_sdr_rx_tpu_torch.parallel import collectives

AXES = ("channel", "time")


class Mesh:
    """A (channel, time) grid of ``torch.device``s. ``shape[axis]`` is the
    number of shards along an axis, as on a JAX mesh; ``group`` is the
    process-group layout of a global mesh, None in one process."""

    def __init__(self, devices, axis_names=AXES, group: "_Group | None" = None):
        self.devices = [list(row) for row in devices]
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (len(self.devices), len(self.devices[0]))))
        self.group = group

    def _pos(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"mesh has axes {self.axis_names}, not {name!r}")
        return self.axis_names.index(name)

    def coords(self) -> list[tuple[int, int]]:
        """The (channel, time) coordinates of the shards this process holds."""
        if self.group:
            return [self.group.coord]
        return [(c, t) for c in range(len(self.devices)) for t in range(len(self.devices[0]))]

    def device(self, coord) -> torch.device:
        return self.devices[coord[0]][coord[1]]

    def lines(self, name: str, first_only: bool = False):
        """The shards this process holds along axis ``name``, and the axis
        object of their collectives: in one process every line of the mesh
        (only the first with ``first_only``, for a function replicated over
        the other axis), line after line, run in lockstep by one
        ``LocalAxis``; in a process group the rank's own shard. Returns
        (coordinates, axis)."""
        pos = self._pos(name)
        if self.group:
            return [self.group.coord], self.group.axes[name]
        size = self.shape[name]
        coords = [(o, k) if pos == 1 else (k, o)
                  for o in range(1 if first_only else self.shape[self.axis_names[1 - pos]])
                  for k in range(size)]
        return coords, collectives.LocalAxis([self.device(c) for c in coords], size)

    def shard(self, x: torch.Tensor, spec: dict, coord) -> torch.Tensor:
        """The piece of global ``x`` at ``coord``, on its device: dimension
        ``spec[axis]`` split evenly over each named axis, the rest whole."""
        for name, dim in spec.items():
            n = self.shape[name]
            if x.shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split "
                                 f"over {n} '{name}' shards")
            size = x.shape[dim] // n
            x = x.narrow(dim, coord[self._pos(name)] * size, size)
        return x.to(self.device(coord))

    def unshard(self, pieces: dict, spec: dict) -> torch.Tensor:
        """The global tensor of ``pieces`` (coordinate -> piece), inverse of
        ``shard``; over an axis the spec does not name, the pieces are
        replicas and the one at coordinate 0 is taken. In one process it lands
        on the device of shard (0, 0); a process group gathers every rank's
        piece, so each rank returns the whole tensor."""
        if self.group:
            pieces = self.group.gather(next(iter(pieces.values())))
        dev = self.devices[0][0] if not self.group else self.group.device
        grid = []
        for c in range(self.shape[self.axis_names[0]] if self.axis_names[0] in spec else 1):
            row = [pieces[(c, t)].to(dev)
                   for t in range(self.shape[self.axis_names[1]] if self.axis_names[1] in spec
                                  else 1)]
            grid.append(torch.cat(row, dim=spec[self.axis_names[1]]) if len(row) > 1
                        else row[0])
        return torch.cat(grid, dim=spec[self.axis_names[0]]) if len(grid) > 1 else grid[0]


    def close(self) -> None:
        """Free what the mesh's collectives hold on the cards (the kernel
        halo's rings across processes); every rank together. A no-op in one
        process."""
        if self.group:
            for axis in self.group.axes.values():
                axis.close()

    def shard_state(self, state, spec: dict, coord):
        """``shard`` on every tensor of a (nested) NamedTuple state; a 0-d
        leaf (a flag for the whole bank) goes whole to the shard's device."""
        return type(state)(*(
            self.shard_state(v, spec, coord) if isinstance(v, tuple)
            else self.shard(v, spec, coord) if v.dim() else v.to(self.device(coord))
            for v in state))

    def unshard_state(self, states: dict, spec: dict):
        """The global state of per-shard states (coordinate -> state), leaf
        by leaf as ``unshard``; a 0-d leaf is taken from the first shard."""
        first = next(iter(states.values()))
        return type(first)(*(
            self.unshard_state({c: s[k] for c, s in states.items()}, spec)
            if isinstance(v, tuple)
            else self.unshard({c: s[k] for c, s in states.items()}, spec) if v.dim() else v
            for k, v in enumerate(first)))


class _Group:
    """The process-group layout of a global mesh: this rank's coordinate and
    device, and one ``GroupAxis`` per mesh axis (the ranks of this rank's
    line along it)."""

    def __init__(self, channel: int, time: int, device: torch.device):
        rank, world = dist.get_rank(), dist.get_world_size()
        if world != channel * time:
            raise ValueError(f"a {channel} x {time} global mesh needs {channel * time} "
                             f"processes, the group has {world}")
        self.coord = (rank // time, rank % time)
        self.device = device
        # every rank creates every group, in the same order (torch.distributed)
        rows = [[c * time + t for t in range(time)] for c in range(channel)]
        cols = [[c * time + t for c in range(channel)] for t in range(time)]
        groups = {"time": [dist.new_group(r) for r in rows],
                  "channel": [dist.new_group(r) for r in cols]}
        c, t = self.coord
        self.axes = {"time": collectives.GroupAxis(rows[c], groups["time"][c], t, device),
                     "channel": collectives.GroupAxis(cols[t], groups["channel"][t], c, device)}

    def gather(self, piece: torch.Tensor) -> dict:
        """Every rank's piece (all of one shape), keyed by coordinate."""
        got = collectives.all_gather_tensor(piece, None, dist.get_world_size())
        time = self.axes["time"].size
        return {(r // time, r % time): g for r, g in enumerate(got.unbind(0))}


def make_mesh(channel: int = 1, time: int = 1, devices=None) -> Mesh:
    """A (channel, time) mesh over ``channel * time`` devices of this process.

    ``devices=None`` takes every CUDA device and raises if there are fewer
    than channel * time (there is no CPU fallback); an explicit list may name
    a device more than once (``[torch.device("cpu")] * 8``)."""
    n = channel * time
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=[torch.device('cpu')]"
                               " * n to run the plain PyTorch versions on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return Mesh([devices[c * time:(c + 1) * time] for c in range(channel)])


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, backend: str | None = None) -> None:
    """Join the process group of a multi-process mesh (a no-op for one
    process). ``coordinator`` is an init URL (``tcp://host:port``,
    ``file:///path``) or ``host:port``; ``backend`` defaults to NCCL when
    CUDA is there, else gloo."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator is None:
        raise ValueError("initialize_distributed needs the coordinator's address")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend or ("nccl" if torch.cuda.is_available() else "gloo"),
                            init_method=url, world_size=num_processes, rank=process_id)


def make_global_mesh(channel: int = 1, time: int = 1, device=None) -> Mesh:
    """A (channel, time) mesh over the process group, one shard per rank:
    rank r holds (r // time, r % time). ``device=None`` puts it on CUDA
    device r mod the count under NCCL, else on the CPU; an explicit device
    (``"cuda:0"``, ``"cpu"``) puts it there under either backend, so several
    gloo ranks can share one card. A card that is not there raises. Channel
    lines then span ranks ``time`` apart and time lines neighbouring ranks.
    Call ``initialize_distributed`` first."""
    if not dist.is_initialized():
        raise RuntimeError("make_global_mesh: call initialize_distributed first")
    if device is None:
        if dist.get_backend() == "nccl":
            device = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        else:
            device = torch.device("cpu")
    else:
        device = torch.device(device)
        if device.type == "cuda":
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            index = device.index if device.index is not None else 0
            if index >= count:
                raise RuntimeError(f"make_global_mesh: no {device} here ({count} CUDA "
                                   "device(s)); there is no CPU fallback")
            device = torch.device("cuda", index)
    group = _Group(channel, time, device)
    grid = [[None] * time for _ in range(channel)]
    c, t = group.coord
    grid[c][t] = device
    return Mesh(grid, group=group)
