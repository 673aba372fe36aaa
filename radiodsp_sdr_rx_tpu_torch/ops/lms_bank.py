"""The LMS noise reducer / auto-notch of a channel bank in one kernel launch.

Counterpart of ``radiodsp_sdr_rx_tpu/ops/pallas_lms.py``: ``lms_nr_run_bank``
takes and returns what ``lms_nr_run_pallas`` (:380) does, (out, weights',
window', delay') for x (C, n), and computes ``ops/lms.py``'s recurrence for
every channel at once. CUDA tensors launch ``csrc/lms.cu`` (``lms_nr``, the
K3 kernel: one warp per channel, the whole segment in one launch) or raise;
CPU tensors run ``lms_nr_run_bank_plain``, the per-sample recurrence over
(C, n) vectorised across channels, which the tests and ``chip_smoke.py``
hold the kernel to. ``LAUNCHES`` counts the launches.

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

LAUNCHES = 0   # lms_nr
MODES = ("denoise", "notch")


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


def lms_nr_run_bank_plain(x, weights, window, delay, first, mu, mode="denoise"):
    """Plain PyTorch version: the per-sample recurrence, vectorised across
    channels. Every window is a slice of [window | x]; its energy is summed
    afresh for every step (all steps at once, before the loop, since it
    depends on the input alone), then the loop runs y, e and the update."""
    _check_args(x, weights, window, delay, mode)
    c, n = x.shape
    xp = torch.cat([window, x], dim=1)            # window[j] = x[j - 96]
    shifted = torch.cat([delay, x], dim=1)[:, :n]
    quirk = _first(first, x.device) & (torch.arange(n, device=x.device) < LMS_DELAY)
    d = torch.where(quirk, x, shifted)
    den = (xp * xp).unfold(1, LMS_TAPS, 1)[:, 1:].sum(-1) + _EPS   # (C, n)
    mu = float(np.float32(mu))
    w = weights.clone()
    out = torch.empty_like(x)
    for t in range(n):
        win = xp[:, t + 1:t + 1 + LMS_TAPS]
        y = (w * win).sum(-1)
        e = d[:, t] - y
        w.addcmul_(((mu * e) / den[:, t])[:, None], win)
        out[:, t] = y if mode == "denoise" else e
    return out, w, xp[:, n:].clone(), next_delay(delay, x)


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
    err = fn(*(t.data_ptr() for t in (x, weights, window, delay, flag, out, w2, win2)),
             c, n, x.device.index or 0, float(np.float32(mu)), int(mode == "notch"),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"lms_nr launch failed: cudaError {err}")
    LAUNCHES += 1
    return out, w2, win2, next_delay(delay, x)
