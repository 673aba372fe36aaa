"""Device placement and the carry-across between the JAX package and the port.

``params_from_numpy`` and ``state_from_numpy`` take the fields of the JAX
package's ``ReceiverParams`` / ``FusedBankState`` as numpy arrays (a dict,
e.g. ``state._asdict()``) and return the port's; ``state_to_numpy`` goes
back. Both packages then compute from the same operators and carries.
DDS phase words are uint32 in JAX and int64 in the port (ops/nco.py).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.models.receiver import ReceiverParams


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; without one that raises. The CPU runs
    only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "plain PyTorch versions on the CPU")
        device = "cuda"
    return torch.device(device)


def params_from_numpy(d: Mapping, device) -> ReceiverParams:
    """Arrays become C-contiguous f32 tensors on ``device`` (the kernels
    take row-major operators; the designed ones are column-major); 0-d values (gains, AGC
    constants, the phase increment) become Python scalars, which the kernels
    take as arguments; ``None`` stays ``None``."""
    out = {}
    for name in ReceiverParams._fields:
        v = d.get(name)
        if v is not None:
            a = np.asarray(v)
            v = (torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
                 if a.ndim else a.item())
        out[name] = v
    return ReceiverParams(**out)


def state_from_numpy(d: Mapping, device):
    """JAX ``FusedBankState`` fields -> the port's ``FusedBankState``."""
    from radiodsp_sdr_rx_tpu_torch.models.fused import FusedBankState

    return FusedBankState(**{
        name: torch.as_tensor(
            np.asarray(d[name]).astype(np.int64 if name == "nco_phase" else np.float32),
            device=device)
        for name in FusedBankState._fields})


def state_to_numpy(state) -> dict[str, np.ndarray]:
    """The port's ``FusedBankState`` -> numpy fields of the JAX state."""
    return {name: v.cpu().numpy().astype(np.uint32 if name == "nco_phase" else np.float32)
            for name, v in state._asdict().items()}
