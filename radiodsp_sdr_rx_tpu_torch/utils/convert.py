"""Device placement and the carry-across between the JAX package and the port.

``params_from_numpy`` and ``state_from_numpy`` take the fields of the JAX
package's ``ReceiverParams`` and of its bank states (``FusedBankState``,
``FusedAMBankState``, ``FusedNRBankState``, ``FusedSAMBankState`` with its
PLL planes padded to the JAX bank's lanes, the nested ``ReceiverState`` with
its ``sam`` PLL state, the sharded chain's ``ShardedChainState`` with its
complex64 tails and (C,) LMS ``first`` flags, the scope's ``ScopeState``
and the channelized bank's ``ChannelizedState``) as numpy arrays (a dict,
e.g. ``state._asdict()``; nested states as NamedTuples or dicts) and return
the port's; ``state_to_numpy`` goes back, nested states as dicts. Both
packages then compute from the same operators and carries. DDS words
(``nco_phase``, the channelized bank's ``nco``) are uint32 in JAX and int64
in the port (ops/nco.py); the LMS ``first`` flags stay bool and complex
leaves complex64.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; without one that raises. The CPU runs
    only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "plain PyTorch versions on the CPU")
        device = "cuda"
    return torch.device(device)


def split_iq(iq, n_channels: int) -> tuple[np.ndarray, np.ndarray]:
    """Complex IQ at the host boundary, (C, n) or (n,) for every channel ->
    planar f32 numpy (re, im), each (C, n)."""
    iq = np.asarray(iq)
    if iq.ndim == 1:
        iq = np.broadcast_to(iq, (n_channels,) + iq.shape)
    return (np.ascontiguousarray(iq.real, np.float32),
            np.ascontiguousarray(iq.imag, np.float32))


def params_from_numpy(d: Mapping, device):
    """Arrays become C-contiguous f32 tensors on ``device`` (the kernels
    take row-major operators; the designed ones are column-major), a bank's
    (C,) phase increments int64; 0-d values (gains, AGC constants, the phase
    increment) become Python scalars, which the kernels take as arguments;
    ``None`` stays ``None``. Returns the port's ``ReceiverParams``."""
    from radiodsp_sdr_rx_tpu_torch.models.receiver import ReceiverParams

    out = {}
    for name in ReceiverParams._fields:
        v = d.get(name)
        if v is not None:
            a = np.asarray(v)
            dtype = np.int64 if name == "nco_inc" else np.float32
            v = (torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)
                 if a.ndim else a.item())
        out[name] = v
    return ReceiverParams(**out)


DDS_WORDS = ("nco_phase", "nco")   # the state fields that hold DDS phase words


def _state_types():
    from radiodsp_sdr_rx_tpu_torch.models.channelized import ChannelizedState
    from radiodsp_sdr_rx_tpu_torch.models.fused import (
        FusedAMBankState,
        FusedBankState,
        FusedNRBankState,
        FusedSAMBankState,
    )
    from radiodsp_sdr_rx_tpu_torch.models.metrics import ScopeState
    from radiodsp_sdr_rx_tpu_torch.models.receiver import ReceiverState
    from radiodsp_sdr_rx_tpu_torch.ops.lms import LMSState
    from radiodsp_sdr_rx_tpu_torch.ops.planar import SAMStatePlanar
    from radiodsp_sdr_rx_tpu_torch.parallel.stream_shard import ShardedChainState

    return (FusedBankState, FusedAMBankState, FusedNRBankState, FusedSAMBankState,
            ReceiverState, ShardedChainState, ScopeState, ChannelizedState), {
        "lms": LMSState, "sam": SAMStatePlanar}


def _fields(v) -> Mapping:
    return v._asdict() if hasattr(v, "_asdict") else v


def state_from_numpy(d: Mapping, device):
    """The fields of a JAX bank state -> the port's state of the same fields
    (``FusedBankState``, ``FusedAMBankState``, ``FusedNRBankState``,
    ``FusedSAMBankState``, ``ReceiverState``, ``ShardedChainState``,
    ``ScopeState`` or ``ChannelizedState``)."""
    tops, nested = _state_types()
    d = _fields(d)
    cls = next((t for t in tops if set(t._fields) == set(d)), None)
    if cls is None:
        raise ValueError(f"no port state has the fields {sorted(d)}")

    def leaf(name, v):
        a = np.array(v)   # a writable copy: JAX hands out read-only arrays
        if name in DDS_WORDS:
            a = a.astype(np.int64)
        elif a.dtype != np.bool_:
            a = a.astype(np.complex64 if np.iscomplexobj(a) else np.float32)
        return torch.as_tensor(a, device=device)

    def build(t, fields):
        return t(**{name: build(nested[name], _fields(v)) if name in nested
                    else leaf(name, v) for name, v in fields.items()})

    return build(cls, d)


def state_to_numpy(state) -> dict:
    """A port bank state -> numpy fields of the JAX state (nested states as
    dicts)."""
    def leaf(name, v):
        a = v.cpu().numpy()
        if name in DDS_WORDS:
            return a.astype(np.uint32)
        if a.dtype == np.bool_:
            return a
        return a.astype(np.complex64 if np.iscomplexobj(a) else np.float32)

    return {name: state_to_numpy(v) if hasattr(v, "_asdict") else leaf(name, v)
            for name, v in state._asdict().items()}
