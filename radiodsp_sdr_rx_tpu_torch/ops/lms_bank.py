"""The LMS noise reducer / auto-notch of a channel bank in one kernel launch.

Counterpart of ``radiodsp_sdr_rx_tpu/ops/pallas_lms.py``: ``lms_nr_run_bank``
takes and returns what ``lms_nr_run_pallas`` (:380) does, (out, weights',
window', delay') for x (C, n), and computes ``ops/lms.py``'s recurrence for
every channel at once. CUDA tensors launch ``csrc/lms.cu`` (``lms_nr``, the
K3 kernel: three warps per channel, the whole segment in one launch) or
raise; CPU tensors run ``lms_nr_run_bank_plain``, which the tests and
``chip_smoke.py`` hold the kernel to: the kernel's grouped exact algebra
(``lms_grouped``: groups of LMS_GROUP samples, the lag products summed
afresh every LMS_REBASE samples), batched across channels, a few tensor
calls per group. ``LAUNCHES`` counts the launches.

The JAX wrapper pads channels to 128 lanes and walks time in 4096-sample
chunks with the state carried between them, both to fit the TPU; the kernel
walks any C and n in one launch, and the state carried between segments is
the same. ``first`` may be a bool or a (C,) bool tensor; as in the JAX bank,
the quirk applies when every channel is on its first block.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.ops.chain_common import check_launch, check_tensors
from radiodsp_sdr_rx_tpu_torch.ops.lms import _EPS, LMS_DELAY, LMS_TAPS
from radiodsp_sdr_rx_tpu_torch.utils import build
from radiodsp_sdr_rx_tpu_torch.utils.profiling import span

LAUNCHES = 0   # lms_nr
MODES = ("denoise", "notch")
LMS_GROUP = 16      # samples per group of the grouped algebra (csrc/lms_step.cuh kGroup)
LMS_REBASE = 128    # the lag products are summed afresh every LMS_REBASE samples (kRebase)
_CHUNK = 64 * LMS_REBASE   # samples whose input-only terms are formed at once


def _check_args(x, weights, window, delay, mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if x.dim() != 2 or x.shape[1] == 0:
        raise ValueError(f"x must be (C, n) with n > 0, got {tuple(x.shape)}")
    c, n = x.shape
    f32 = torch.float32
    check_tensors({"weights": (weights, (c, LMS_TAPS), f32),
                   "window": (window, (c, LMS_TAPS), f32),
                   "delay": (delay, (c, LMS_DELAY), f32),
                   "x": (x, (c, n), f32)}, x.device)


def _first(first, device) -> torch.Tensor:
    """The first-block flag as a 0-d bool tensor on ``device`` (no sync)."""
    return torch.as_tensor(first, dtype=torch.bool, device=device).all()


def next_delay(delay: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The delay line after x: the last LMS_DELAY samples of [delay | x]."""
    n = x.shape[1]
    if n >= LMS_DELAY:
        return x[:, n - LMS_DELAY:].clone()
    return torch.cat([delay[:, n:], x], dim=1)


def _lag_products(xp, s0, s1):
    """R (C, s1 - s0, LMS_GROUP): R[:, m - s0, d] = win_m . win_{m+d}, win_m =
    xp[:, m+1 : m+97], as the kernel forms them: summed afresh at every
    multiple b of LMS_REBASE and telescoped from there,
    R_m = R_b + sum_{e=b+1}^{m} (x[e] x[e+d] - x[e-96] x[e-96+d]).
    s0 and s1 are multiples of LMS_REBASE; xp holds 96 + s1 + LMS_GROUP - 1
    samples or more."""
    c, u = xp.shape[0], LMS_GROUP
    wins = xp.unfold(1, LMS_TAPS, 1)                                # wins[:, m+1] = win_m
    starts = torch.arange(s0, s1, LMS_REBASE, device=xp.device)
    lags = starts[:, None] + torch.arange(u, device=xp.device)      # (blocks, U)
    fresh = (wins[:, starts + 1, None, :] * wins[:, lags + 1, :]).sum(-1)
    new = xp[:, LMS_TAPS + s0:LMS_TAPS + s1]                          # x[e]
    old = xp[:, s0:s1]                                              # x[e - 96]
    delta = (new[..., None] * xp[:, LMS_TAPS + s0:LMS_TAPS + s1 + u - 1].unfold(1, u, 1)
             - old[..., None] * xp[:, s0:s1 + u - 1].unfold(1, u, 1))
    delta = delta.view(c, -1, LMS_REBASE, u)
    delta[:, :, 0] = 0.0
    return (torch.cumsum(delta, 2) + fresh[:, :, None]).view(c, s1 - s0, u)


def lms_grouped(x, weights, window, delay, first, mu, mode="denoise"):
    """The grouped exact algebra of csrc/lms_step.cuh in x's dtype, with the
    kernel's group (LMS_GROUP) and rebase schedule (LMS_REBASE), batched over
    channels: per group of U samples from t0, with inv_k = mu / (||win_k||^2
    + eps), r_{j,k} = win_j . win_k and p = w . win_k from the weights at t0,
    the chain e_k = d_k - y_k, c_k = e_k inv_k, y_k = p_k + sum_{j<k} c_j
    r_{j,k} is one unit-lower-triangular system L c = inv * (d - p), L_kj =
    inv_k r_{j,k}; then w += sum_k c_k win_k. A short last group has c_k =
    0 past n. The arguments as ``lms_nr_run_bank``'s, unchecked."""
    c, n = x.shape
    u = LMS_GROUP
    npad = -(-n // LMS_REBASE) * LMS_REBASE
    xp = torch.cat([window, x, x.new_zeros(c, npad - n + u)], dim=1)   # xp[:, 96 + m] = x[m]
    shifted = torch.cat([delay, x], dim=1)[:, :n]
    quirk = _first(first, x.device) & (torch.arange(n, device=x.device) < LMS_DELAY)
    d = torch.cat([torch.where(quirk, x, shifted), x.new_zeros(c, npad - n)], dim=1)
    mu = float(np.float32(mu))
    wins = xp.unfold(1, LMS_TAPS, 1)
    below = torch.arange(u, device=x.device)
    lag = below[:, None] - below[None, :]                   # [k, j] -> k - j
    strict = lag > 0
    flat = (below[None, :] * u + lag.clamp(min=0)).view(-1)   # [k, j] -> R[j, k - j]
    eye = torch.eye(u, dtype=x.dtype, device=x.device)
    w = weights.clone()
    out = x.new_empty(c, npad)
    for s0 in range(0, npad, _CHUNK):
        s1 = min(s0 + _CHUNK, npad)
        g = (s1 - s0) // u
        r = _lag_products(xp, s0, s1).view(c, g, u, u)      # [.., k, d] = r_{k, k+d}
        inv = mu / (r[..., 0] + _EPS)                       # (C, G, U)
        if s1 > n:
            inv = inv.masked_fill((torch.arange(s0, s1, device=x.device) >= n).view(g, u), 0.0)
        rlow = torch.where(strict, r.view(c, g, u * u)[..., flat].view(c, g, u, u), 0.0)
        system = eye + inv[..., None] * rlow                # L
        dg = d[:, s0:s1].view(c, g, u)
        for k in range(g):
            t0 = s0 + k * u
            win = wins[:, t0 + 1:t0 + 1 + u]                # (C, U, 96)
            p = (win @ w[:, :, None])[..., 0]
            cc = torch.linalg.solve_triangular(system[:, k], (inv[:, k] * (dg[:, k] - p))[..., None],
                                               upper=False, unitriangular=True)
            y = p + (rlow[:, k] @ cc)[..., 0]
            out[:, t0:t0 + u] = y if mode == "denoise" else dg[:, k] - y
            w = w + (cc.transpose(1, 2) @ win)[:, 0]
    return out[:, :n].contiguous(), w, xp[:, n:n + LMS_TAPS].clone(), next_delay(delay, x)


def lms_nr_run_bank_plain(x, weights, window, delay, first, mu, mode="denoise"):
    """Plain PyTorch version: ``lms_grouped``, the kernel's algebra, group
    and rebase schedule, a few tensor calls per group of LMS_GROUP samples."""
    _check_args(x, weights, window, delay, mode)
    return lms_grouped(x, weights, window, delay, first, mu, mode)


def lms_nr_run_bank(x, weights, window, delay, first, mu, mode="denoise"):
    """Normalised LMS over a bank segment.

      x:        (C, n) f32
      weights:  (C, 96) f32;  window: (C, 96) f32, index -1 newest
      delay:    (C, 128) f32, the previous segment's last 128 inputs
      first:    bool or (C,) bool: the reference's first-block quirk
      mu:       step size;  mode: "denoise" (out y) or "notch" (out e)

    Returns (out (C, n), weights', window', delay'). CPU tensors run the
    plain version; CUDA tensors launch the kernel, or raise.
    """
    global LAUNCHES
    if x.device.type == "cpu":
        return lms_nr_run_bank_plain(x, weights, window, delay, first, mu, mode)
    if x.device.type != "cuda":
        raise ValueError(f"lms_nr_run_bank runs on cuda or cpu, not {x.device}")
    _check_args(x, weights, window, delay, mode)
    check_launch("lms_nr_run_bank", (x, weights, window, delay))
    c, n = x.shape
    flag = _first(first, x.device).to(torch.uint8)
    out = torch.empty_like(x)
    w2, win2 = torch.empty_like(weights), torch.empty_like(window)
    fn = build.load_library("lms").lms_nr
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                                ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with span("rdsp.launch", kernel="lms_nr"):
        err = fn(*(t.data_ptr() for t in (x, weights, window, delay, flag, out, w2, win2)),
                 c, n, x.device.index or 0, float(np.float32(mu)), int(mode == "notch"), stream)
    if err:
        raise RuntimeError(f"lms_nr launch failed: cudaError {err}")
    LAUNCHES += 1
    return out, w2, win2, next_delay(delay, x)
