"""Channel-shard the fused banks over a mesh (``radiodsp_sdr_rx_tpu/parallel/fused_shard.py``).

The fused banks (``models/fused.py``) share nothing across channels, so a
wide bank shards over the mesh's channel axis as one bank per shard: each on
its shard's device, with its slice of the frequencies, running the bank's
own kernel; the per-channel state and IQ split on the channel axis and the
shards' results concatenate.

>>> mesh = make_mesh(channel=8)
>>> bank = ShardedFusedBank(cfg, freqs_1024, mesh)   # the class picked from cfg
>>> out, state = bank.process_planar(xr, xi, bank.init_state())

The global state is the shards' states stacked on dim 0, leaf by leaf, as
the JAX class widens and splits it: a (C, ...) leaf is the whole bank's, a
padded one (the LMS rows, the PLL planes) holds each shard's padded block in
turn, so the NR bank's ``pll`` (2, lanes) becomes (2 * shards, lanes). A 0-d
leaf (the LMS ``first`` flag) is one flag for the whole bank.
"""

from __future__ import annotations

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.models import fused
from radiodsp_sdr_rx_tpu_torch.models.config import DemodMode, ReceiverConfig
from radiodsp_sdr_rx_tpu_torch.ops import nco
from radiodsp_sdr_rx_tpu_torch.parallel.mesh import Mesh

def _pick_cls(config: ReceiverConfig):
    """The fused bank of a config: NR on FusedNRBank, then SAM, AM, SSB."""
    if config.nr.kind != "off":
        return fused.FusedNRBank
    if config.mode == DemodMode.SAM:
        return fused.FusedSAMBank
    if config.mode == DemodMode.AM:
        return fused.FusedAMBank
    return fused.FusedSSBBank


def _incs_like(config: ReceiverConfig, freqs: np.ndarray) -> np.ndarray:
    """(C,) uint32 DDS increments with the banks' own formula."""
    return nco.bank_phase_incs(config, freqs)


class ShardedFusedBank:
    """A fused bank channel-sharded over ``mesh`` axis ``axis_name``: the
    surface of the bank (init_state, process, process_planar) for
    len(freqs_hz) % mesh.shape[axis_name] == 0 channels. Extra keywords go to
    the bank's constructor (fold, backend, ...); ``cls`` overrides the pick."""

    def __init__(self, config: ReceiverConfig, freqs_hz, mesh: Mesh,
                 axis_name: str = "channel", cls=None, **bank_kw):
        n_dev = mesh.shape[axis_name]
        freqs = np.asarray(freqs_hz, np.float64)
        if len(freqs) % n_dev:
            raise ValueError(f"{len(freqs)} channels not divisible by {n_dev} "
                             f"'{axis_name}' devices")
        per = len(freqs) // n_dev
        cls = cls or _pick_cls(config)
        pos = mesh.axis_names.index(axis_name)
        self.coords, _ = mesh.lines(axis_name, first_only=True)
        self.banks = {c: cls(config, freqs[c[pos] * per:(c[pos] + 1) * per],
                             device=mesh.device(c), **bank_kw) for c in self.coords}
        self.template = self.banks[self.coords[0]]
        self.n_channels = len(freqs)
        self.config = config
        self.mesh = mesh
        self.axis_name = axis_name
        self.incs = _incs_like(config, freqs)

    def init_state(self):
        return self.mesh.unshard_state({c: b.init_state() for c, b in self.banks.items()},
                                       {self.axis_name: 0})

    def process_planar(self, xr, xi, state):
        xr = torch.as_tensor(xr, dtype=torch.float32)
        xi = torch.as_tensor(xi, dtype=torch.float32)
        spec = {self.axis_name: 0}
        outs, states = {}, {}
        for c, bank in self.banks.items():
            outs[c], states[c] = bank.process_planar(
                self.mesh.shard(xr, spec, c), self.mesh.shard(xi, spec, c),
                self.mesh.shard_state(state, spec, c))
        return ({k: self.mesh.unshard({c: o[k] for c, o in outs.items()}, spec)
                 for k in ("audio_l", "audio_r")}, self.mesh.unshard_state(states, spec))

    def process(self, iq, state):
        """Complex IQ at the host boundary: (C, n), or (n,) for every channel."""
        iq = np.asarray(iq)
        if iq.ndim == 1:
            iq = np.broadcast_to(iq, (self.n_channels,) + iq.shape)
        return self.process_planar(np.ascontiguousarray(iq.real, np.float32),
                                   np.ascontiguousarray(iq.imag, np.float32), state)
