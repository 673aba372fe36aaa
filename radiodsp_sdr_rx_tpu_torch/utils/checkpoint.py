"""Checkpoint / resume of carried state (``radiodsp_sdr_rx_tpu/utils/checkpoint.py``).

Every carried quantity of the port is an explicit NamedTuple of tensors
(``ReceiverState``, ``ScopeState``, ``ChannelizedState``, the bank states),
so a checkpoint is a flat ``.npz`` of named leaves plus the
``ReceiverConfig`` as JSON, and a resumed stream continues bit for bit.

The names are the JAX package's: the ``_path_str`` of
``jax.tree_util.tree_flatten_with_path``, walked here without JAX (a
NamedTuple field gives its name, a sequence its index, a dict its key, and
``None`` is an empty subtree), joined by "/". The DDS words are saved as
uint32, as JAX holds them (``utils/convert.DDS_WORDS``; int64 in the port).
So a checkpoint written by either package loads in the other. Tensors on a
card are saved through ``.cpu()``; a loaded leaf takes its template leaf's
dtype, shape and device.
"""

from __future__ import annotations

import dataclasses
import enum
import json

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.models.config import (
    AGCMode, AudioFilter, DemodMode, FilterWindow, NRMode, ReceiverConfig,
)
from radiodsp_sdr_rx_tpu_torch.utils.convert import DDS_WORDS


def _children(tree):
    """(key, child) pairs of a NamedTuple, dict or sequence; None if a leaf."""
    if hasattr(tree, "_fields"):
        return [(name, getattr(tree, name)) for name in tree._fields]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def flatten_with_paths(tree, prefix: tuple = ()) -> list[tuple[str, object]]:
    """The leaves of ``tree`` with the JAX checkpoint's key of each."""
    if tree is None:
        return []
    children = _children(tree)
    if children is None:
        return [("/".join(prefix), tree)]
    return [leaf for key, child in children
            for leaf in flatten_with_paths(child, prefix + (key,))]


def _to_numpy(key: str, leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        a = leaf.detach().cpu().numpy()
    else:
        a = np.asarray(leaf)
    if key.rsplit("/", 1)[-1] in DDS_WORDS:
        if a.size and (a.min() < 0 or a.max() > 0xFFFFFFFF):
            raise ValueError(f"{key}: DDS words must lie in [0, 2^32)")
        a = a.astype(np.uint32)
    return a


def save_state(path: str, state, config: ReceiverConfig | None = None) -> None:
    """Save a state (``ReceiverState``, ``ScopeState``, ...) to ``path``."""
    arrays = {key: _to_numpy(key, leaf) for key, leaf in flatten_with_paths(state)}
    if config is not None:
        arrays["__config__"] = np.frombuffer(config_to_json(config).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def _leaf(data, key: str, tmpl):
    if key not in data:
        # version skew: the state grew a field since the checkpoint was
        # written; resume with the template's leaf
        return tmpl
    a = data[key]
    if torch.is_tensor(tmpl):
        dtype = torch.empty(0, dtype=tmpl.dtype).numpy().dtype
        # np.array, not ascontiguousarray, which would give a 0-d leaf an axis
        return torch.from_numpy(np.array(a.astype(dtype).reshape(tuple(tmpl.shape)),
                                         order="C")).to(tmpl.device)
    return a.astype(np.asarray(tmpl).dtype).reshape(np.shape(tmpl))


def _rebuild(data, tmpl, prefix: tuple):
    if tmpl is None:
        return None
    children = _children(tmpl)
    if children is None:
        return _leaf(data, "/".join(prefix), tmpl)
    built = [_rebuild(data, child, prefix + (key,)) for key, child in children]
    if hasattr(tmpl, "_fields"):
        return type(tmpl)(*built)
    if isinstance(tmpl, dict):
        return dict(zip(sorted(tmpl), built))
    return type(tmpl)(built)


def load_state(path: str, template):
    """Load a state saved by ``save_state`` (of either package), shaped like
    ``template``. Returns (state, config or None)."""
    with np.load(path) as data:
        state = _rebuild(data, template, ())
        config = None
        if "__config__" in data:
            config = config_from_json(bytes(data["__config__"]).decode())
    return state, config


def config_to_json(config: ReceiverConfig) -> str:
    d = {}
    for f in dataclasses.fields(config):
        v = getattr(config, f.name)
        d[f.name] = v.name if isinstance(v, enum.Enum) else v
    return json.dumps(d)


_ENUMS = {
    "mode": DemodMode, "audio_filter": AudioFilter, "agc": AGCMode,
    "nr": NRMode, "fir_window": FilterWindow,
}


def config_from_json(s: str) -> ReceiverConfig:
    d = json.loads(s)
    for k, enum_cls in _ENUMS.items():
        if d.get(k) is not None:
            d[k] = enum_cls[d[k]]
    return ReceiverConfig(**d)
