"""First- and second-order IIR sections as parallel scans (``radiodsp_sdr_rx_tpu/ops/iir.py``).

A one-pole recurrence y[n] = a*y[n-1] + b*x[n] is a linear scan. The JAX
package runs it as ``jax.lax.associative_scan`` over affine maps; here it is
the same scan as Hillis-Steele doubling along the last axis, log2(n) passes
of ``y += a^(2^k) * y shifted by 2^k``, in f32. Plain PyTorch, as the JAX
functions are XLA outside any Pallas kernel.

The biquad (the panadapter's 500 Hz high-pass, RadioDSP_SDR_RX.ino:155-156)
is a per-sample ``lax.scan`` in JAX. Here its direct-form-II-transposed
recurrence runs as the same doubling on its 2x2 state-space form, s[n+1] =
A s[n] + B x[n], y[n] = b0 x[n] + s1[n]: log2(n) passes of ``z += A^(2^k)
z shifted by 2^k`` (two shifts and four scaled adds, ``torch.add``'s
``alpha``), a fixed number of launches a pass, so a block costs launches in
log2 of its length and none a sample. The powers of A are
computed on the host in float64 and rounded to f32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

DC_POLE = 0.995   # the AM DC blocker's pole


def first_order_iir(x: torch.Tensor, a, b, y0: torch.Tensor):
    """y[n] = a*y[n-1] + b*x[n] along the last axis, with y[-1] = y0.

    x: (..., n) f32; a, b: scalars (Python or 0-d tensors, taken as f32);
    y0: (...,) carry. Returns (y, y_last).
    """
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    y = torch.as_tensor(b, dtype=x.dtype, device=x.device) * x
    y = torch.cat([y[..., :1] + a * y0[..., None], y[..., 1:]], dim=-1)
    f, sh = a, 1
    while sh < y.shape[-1]:
        y = y + f * F.pad(y[..., :-sh], (sh, 0))
        f, sh = f * f, 2 * sh
    return y, y[..., -1]


def dc_blocker(x: torch.Tensor, y0: torch.Tensor, pole: float = DC_POLE):
    """DC blocker y[n] = x[n] - x[n-1] + pole*y[n-1] along the last axis.

    y0: (..., 2) carry = (last input sample, last output sample).
    Returns (y, new_carry).
    """
    x_prev = torch.cat([y0[..., :1], x[..., :-1]], dim=-1)
    y, y_last = first_order_iir(x - x_prev, pole, 1.0, y0[..., 1])
    return y, torch.stack([x[..., -1], y_last], dim=-1)


class BiquadCoeffs(NamedTuple):
    b0: float
    b1: float
    b2: float
    a1: float  # sign convention: y[n] = b0 x + b1 x1 + b2 x2 - a1 y1 - a2 y2
    a2: float


def biquad_highpass(f0: float, sample_rate: float, q: float = 0.5) -> BiquadCoeffs:
    """RBJ cookbook high-pass, matching Teensy AudioFilterBiquad.setHighpass
    (call site RadioDSP_SDR_RX.ino:155-156: stage 0, 500 Hz, Q=0.5)."""
    w0 = 2.0 * math.pi * f0 / sample_rate
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    a0 = 1.0 + alpha
    return BiquadCoeffs(
        b0=(1.0 + cw) / 2.0 / a0,
        b1=-(1.0 + cw) / a0,
        b2=(1.0 + cw) / 2.0 / a0,
        a1=(-2.0 * cw) / a0,
        a2=(1.0 - alpha) / a0,
    )


def _f32(v) -> float:
    return float(np.float32(v))


def biquad_apply(x: torch.Tensor, coeffs: BiquadCoeffs, state0: torch.Tensor):
    """Direct-form-II-transposed biquad along the last axis.

    x: (..., n) f32; state0: (..., 2) the (s1, s2) carry. Returns (y, new
    state (..., 2)). Every scalar is a Python float, so the call copies
    nothing between host and device.
    """
    c = coeffs
    a = np.array([[-c.a1, 1.0], [-c.a2, 0.0]])     # s[n+1] = A s[n] + B x[n]
    b = (c.b1 - c.a1 * c.b0, c.b2 - c.a2 * c.b0)
    s1, s2 = state0[..., 0], state0[..., 1]
    # z[n] = s[n+1], the state after sample n, with A s0 folded into z[0]
    z0, z1 = _f32(b[0]) * x, _f32(b[1]) * x
    z0 = torch.cat([z0[..., :1] + (_f32(a[0, 0]) * s1 + s2)[..., None], z0[..., 1:]], dim=-1)
    z1 = torch.cat([z1[..., :1] + (_f32(a[1, 0]) * s1)[..., None], z1[..., 1:]], dim=-1)
    p, sh = a, 1
    while sh < x.shape[-1]:
        u0, u1 = F.pad(z0[..., :-sh], (sh, 0)), F.pad(z1[..., :-sh], (sh, 0))
        z0, z1 = (torch.add(torch.add(z0, u0, alpha=_f32(p[0, 0])), u1, alpha=_f32(p[0, 1])),
                  torch.add(torch.add(z1, u0, alpha=_f32(p[1, 0])), u1, alpha=_f32(p[1, 1])))
        p, sh = p @ p, 2 * sh
    y = _f32(c.b0) * x + torch.cat([s1[..., None], z0[..., :-1]], dim=-1)
    return y, torch.stack([z0[..., -1], z1[..., -1]], dim=-1)
