"""Plain PyTorch pieces shared by the sweep and staged chains.

The DDS mix, the two overlap-save framings with their fp32 products, the
decaying-sum row scan, the argument checks of the kernel wrappers, and the
cache of what the wrappers make once per operator (``per_operator``).
``ops/sweep.py``, ``ops/sweep_spec.py`` and ``ops/staged.py`` build their
plain versions from these, so every backend's reference frames and mixes the
stream the same way; ``csrc/chain_common.cuh`` is the device side of the
same pieces.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

BLOCK = 128
_PHASE_SCALE = np.float32(2.0 * np.pi / 4294967296.0)
# (kind, the operators' data pointers and versions) -> (their weakrefs, the value)
_PER_OPERATOR: dict = {}


def matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full fp32, as the kernels compute it: on the card TF32 is
    switched off for this product and the setting restored after it."""
    if not a.is_cuda:
        return torch.matmul(a, b)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def iir_rows(seq: torch.Tensor, pole: float) -> torch.Tensor:
    """Inclusive decaying-sum scan along the last axis: y[k] = seq[k] +
    pole * y[k-1], y[-1] = 0, as Hillis-Steele doubling with the factor
    pole^sh rounded to f32, as the TPU kernels' row scans compute it."""
    sh = 1
    while sh < seq.shape[-1]:
        f = float(np.float32(pole ** sh))
        seq = seq + torch.nn.functional.pad(seq[..., :-sh], (sh, 0)) * f
        sh *= 2
    return seq


def mix(xr, xi, phase0, inc, positions):
    """Mix (already scaled) IQ down by the DDS phase phase0 + position*inc
    (uint32 wrap), read as int32 before the float conversion, as the TPU
    kernel does."""
    phase = (phase0[:, None] + positions[None, :] * inc[:, None]) & 0xFFFFFFFF
    phase = torch.where(phase >= 1 << 31, phase - (1 << 32), phase)
    ang = phase.to(torch.int32).to(torch.float32) * float(_PHASE_SCALE)
    c, s = torch.cos(ang), torch.sin(ang)
    return xr * c + xi * s, xi * c - xr * s


def demod_frames(br, bi, tr, ti, w_ssb):
    """Mixed stream (C, n) and mixed tail (C, 128): frames
    [prev_r | cur_r | prev_i | cur_i] @ w_ssb -> audio (C, rows, 128)."""
    c, n = br.shape
    br = br.view(c, n // BLOCK, BLOCK)
    bi = bi.view(c, n // BLOCK, BLOCK)
    prev_r = torch.cat([tr[:, None], br[:, :-1]], dim=1)
    prev_i = torch.cat([ti[:, None], bi[:, :-1]], dim=1)
    return matmul_fp32(torch.cat([prev_r, br, prev_i, bi], dim=-1), w_ssb)


def pbt_frames(audio, tail, w_pbt):
    """Audio (C, rows, 128) and its tail (C, 128): frames [prev | cur] @ w_pbt
    -> [L|R] (C, rows, 256)."""
    prev = torch.cat([tail[:, None], audio[:, :-1]], dim=1)
    return matmul_fp32(torch.cat([prev, audio], dim=-1), w_pbt)


def check_tensors(expect: dict, device) -> None:
    """expect: name -> (tensor, shape, dtype); all on ``device``."""
    for name, (t, shape, dtype) in expect.items():
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != device:
            raise ValueError(f"{name}: expected {dtype} {shape} on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def per_operator(kind, operators: tuple, make):
    """``make()``, made once for ``kind`` while the tensors ``operators`` stay
    unchanged (keyed by their data pointers and versions) and kept while they
    live: the kernels' operator images and the spectral operators' check. A
    ``make`` that raises keeps nothing."""
    key = (kind, *((w.data_ptr(), w._version) for w in operators))
    seen = _PER_OPERATOR.get(key)
    if seen is not None and all(ref() is w for ref, w in zip(seen[0], operators)):
        return seen[1]
    value = make()
    for k in [k for k, (refs, _) in _PER_OPERATOR.items() if any(r() is None for r in refs)]:
        del _PER_OPERATOR[k]   # the values of operators gone
    _PER_OPERATOR[key] = (tuple(weakref.ref(w) for w in operators), value)
    return value


def check_stream(xr) -> None:
    if xr.dim() != 2 or xr.shape[1] == 0 or xr.shape[1] % BLOCK:
        raise ValueError(f"xr must be (C, n) with n a positive multiple of "
                         f"{BLOCK}, got {tuple(xr.shape)}")


def check_launch(name: str, tensors) -> None:
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} takes contiguous tensors aligned to 16 bytes")
