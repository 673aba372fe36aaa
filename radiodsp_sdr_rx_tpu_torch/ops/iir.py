"""First-order IIR sections as parallel scans (``radiodsp_sdr_rx_tpu/ops/iir.py:26-48``).

A one-pole recurrence y[n] = a*y[n-1] + b*x[n] is a linear scan. The JAX
package runs it as ``jax.lax.associative_scan`` over affine maps; here it is
the same scan as Hillis-Steele doubling along the last axis, log2(n) passes
of ``y += a^(2^k) * y shifted by 2^k``, in f32. Plain PyTorch, as the JAX
functions are XLA outside any Pallas kernel. The biquads of the same module
come with the scopes (ROADMAP item 8).
"""

from __future__ import annotations

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
