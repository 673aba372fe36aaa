"""The whole SSB receive chain in one kernel launch.

Counterpart of ``radiodsp_sdr_rx_tpu/ops/pallas_sweep.py``: ``sweep_full_chain``
(:628) and the ``demod="ssb"`` variant of its kernel ``_chain_kernel`` (:261).
Per channel, in this order:

  input gain / IQ balance -> [nb=True: noise blanker] -> DDS NCO mix ->
  overlap-save band-pass + SSB demod as (rows,512)@(512,128) -> AGC
  env[k] = max(|a[k]|, env[k-1]*release),
  gain = min(target/max(env, 1e-12), max_gain) -> PBT (rows,256)@(256,256)
  giving [L|R] -> output gain.

The framing tail (the RAW previous block, re-scaled and re-mixed at positions
-128..-1), the AGC envelope and the PBT tail carry from segment to segment.
The noise blanker (``pallas_sweep.py:386-403``) zeroes every scaled sample
whose magnitude exceeds avg*10^(dB/20) + 1e-12, with avg the one-pole mean
of the magnitude (a = exp(-1/tau)); its average and the last block's keep
mask carry too, and the mask gates the re-mixed tail.

``sweep_full_chain`` launches ``csrc/sweep_chain.cu`` for CUDA tensors
(``sweep_chain_ssb``, or ``sweep_chain_ssb_nb`` with ``nb=True``) and raises
if it cannot; for CPU tensors it runs ``sweep_full_chain_plain``, the plain
PyTorch version the tests and ``chip_smoke.py`` hold the kernel to.
``LAUNCHES`` and ``LAUNCHES_NB`` count the two kernels' launches. The JAX
wrapper's TPU tiling knobs (``block_c``, ``chunk_t``, ``interpret``) have no
meaning here and are not taken; ``emit_r=False`` comes with a later slice.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.ops.chain_common import (
    BLOCK,
    check_launch,
    check_stream,
    check_tensors,
    demod_frames,
    mix,
    pbt_frames,
)
from radiodsp_sdr_rx_tpu_torch.utils import build

LAUNCHES = 0      # sweep_chain_ssb
LAUNCHES_NB = 0   # sweep_chain_ssb_nb


def _env_lanes(mag: torch.Tensor, release: float) -> torch.Tensor:
    """Decaying running max along the last axis (128 lanes):
    x[t] = max_{k<=t} mag[k] * release^(t-k), by 7 doubling max-shifts."""
    x = mag
    for sh in (1, 2, 4, 8, 16, 32, 64):
        f = float(np.float32(release ** sh))
        shifted = torch.nn.functional.pad(x[..., :-sh], (sh, 0))
        x = torch.maximum(x, shifted * f)
    return x


def _env_rows(seq: torch.Tensor, release128: float) -> torch.Tensor:
    """Inclusive decaying-max scan along axis 1 of (C, rows), factor
    release^128 per step (Hillis-Steele doubling)."""
    sh = 1
    while sh < seq.shape[1]:
        f = float(np.float32(release128 ** sh))
        shifted = torch.nn.functional.pad(seq[:, :-sh], (sh, 0))
        seq = torch.maximum(seq, shifted * f)
        sh *= 2
    return seq


def _iir_lanes(x: torch.Tensor, pole: float) -> torch.Tensor:
    """The ``+`` twin of ``_env_lanes``: y[t] = sum_{k<=t} x[k] * pole^(t-k)."""
    for sh in (1, 2, 4, 8, 16, 32, 64):
        f = float(np.float32(pole ** sh))
        x = x + torch.nn.functional.pad(x[..., :-sh], (sh, 0)) * f
    return x


def _iir_rows(seq: torch.Tensor, pole128: float) -> torch.Tensor:
    """The ``+`` twin of ``_env_rows``: inclusive decaying-sum scan along
    axis 1 of (C, rows), factor pole^128 per step."""
    sh = 1
    while sh < seq.shape[1]:
        f = float(np.float32(pole128 ** sh))
        seq = seq + torch.nn.functional.pad(seq[:, :-sh], (sh, 0)) * f
        sh *= 2
    return seq


def _lane_decay(p: float, device) -> torch.Tensor:
    """p^(l+1) for lanes l = 0..127, as the TPU kernel computes it in f32."""
    lane1 = torch.arange(1, BLOCK + 1, dtype=torch.float32, device=device)
    if p >= 1.0:
        return torch.ones_like(lane1)
    return torch.exp(float(np.float32(np.log(p))) * lane1)


def nb_constants(nb_thresh_db: float, nb_tau: float) -> tuple[float, float]:
    """(threshold factor 10^(dB/20), pole exp(-1/tau)), both in float64."""
    return 10.0 ** (nb_thresh_db / 20.0), math.exp(-1.0 / nb_tau)


def _blank(xr, xi, avg0, nb_thresh_db, nb_tau):
    """Noise blanker on scaled IQ (C, n): the one-pole mean of |x| by the
    decaying-sum doubling scans (``_iir_lanes`` within a row, ``_iir_rows``
    across rows), samples above avg*thresh + 1e-12 zeroed. Returns
    (xr, xi, avg at the last sample, keep mask of the last row)."""
    thresh, a = nb_constants(nb_thresh_db, nb_tau)
    c, n = xr.shape
    xr = xr.view(c, n // BLOCK, BLOCK)
    xi = xi.view(c, n // BLOCK, BLOCK)
    mag = torch.sqrt(xr * xr + xi * xi)
    run = _iir_lanes(mag * float(np.float32(1.0 - a)), a)
    seq = torch.cat([avg0[:, None], run[:, :-1, -1]], dim=1)
    carry = _iir_rows(seq, float(np.float64(a) ** BLOCK))
    avg = run + carry[:, :, None] * _lane_decay(a, xr.device)
    keep = mag <= avg * float(np.float32(thresh)) + 1e-12
    xr = torch.where(keep, xr, 0.0).view(c, n)
    xi = torch.where(keep, xi, 0.0).view(c, n)
    return xr, xi, avg[:, -1, -1].contiguous(), keep[:, -1].to(torch.float32)


def _check_args(xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i,
                audio_tail, env0, agc_release, nb, nb_tau, nb_avg0, nb_mask0):
    check_stream(xr)
    if not 0.0 < agc_release <= 1.0:
        raise ValueError(f"agc_release must be in (0, 1], got {agc_release}")
    c, n = xr.shape
    f32 = torch.float32
    expect = {"xi": (xi, (c, n), f32),
              "inc": (inc, (c,), torch.int64),
              "phase0": (phase0, (c,), torch.int64),
              "w_ssb": (w_ssb, (512, 128), f32),
              "w_pbt": (w_pbt, (256, 256), f32),
              "tail_r": (tail_r, (c, BLOCK), f32),
              "tail_i": (tail_i, (c, BLOCK), f32),
              "audio_tail": (audio_tail, (c, BLOCK), f32),
              "env0": (env0, (c,), f32),
              "xr": (xr, (c, n), f32)}
    if nb:
        if not nb_tau > 0.0:
            raise ValueError(f"nb_tau must be positive, got {nb_tau}")
        if nb_avg0 is None or nb_mask0 is None:
            raise ValueError("nb=True takes the blanker's carries nb_avg0 and "
                             "nb_mask0 (FusedSSBBank.init_state gives them at "
                             "stream start)")
        expect["nb_avg0"] = (nb_avg0, (c,), f32)
        expect["nb_mask0"] = (nb_mask0, (c, BLOCK), f32)
    check_tensors(expect, xr.device)


def sweep_full_chain_plain(xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i,
                           audio_tail, env0, agc_release, agc_target,
                           agc_max_gain, agc_enabled=True, out_gain=1.0,
                           in_gain=1.0, iq_balance=1.0, nb=False,
                           nb_thresh_db=10.0, nb_tau=512.0, nb_avg0=None,
                           nb_mask0=None):
    """Plain PyTorch version of the chain, vectorised over the whole segment.

    The AGC and the blanker's average run as the TPU kernel's doubling scans
    (within a 128-sample row, then across rows) plus the row carry, with no
    per-sample loop. Both products are full fp32 (``chain_common.matmul_fp32``), as the
    kernel computes them.
    """
    _check_args(xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i,
                audio_tail, env0, agc_release, nb, nb_tau, nb_avg0, nb_mask0)
    c, n = xr.shape
    g_i = float(np.float32(in_gain))
    g_q = float(np.float32(in_gain * iq_balance))
    pos = torch.arange(n, dtype=torch.int64, device=xr.device)
    xr, xi = xr * g_i, xi * g_q
    tr, ti = mix(tail_r * g_i, tail_i * g_q, phase0, inc, pos[:BLOCK] - BLOCK)
    if nb:
        xr, xi, nb_avg, nb_mask = _blank(xr, xi, nb_avg0, nb_thresh_db, nb_tau)
        tr, ti = tr * nb_mask0, ti * nb_mask0
    br, bi = mix(xr, xi, phase0, inc, pos)
    del xr, xi
    audio = demod_frames(br, bi, tr, ti, w_ssb)
    del br, bi

    run_e = _env_lanes(audio.abs(), agc_release)
    seq_e = torch.cat([env0[:, None], run_e[:, :-1, -1]], dim=1)
    carry_e = _env_rows(seq_e, float(np.float64(agc_release) ** BLOCK))
    envl = torch.maximum(run_e, carry_e[:, :, None] * _lane_decay(agc_release, audio.device))
    if agc_enabled:
        target = torch.tensor(float(np.float32(agc_target)), device=audio.device)
        gain = torch.clamp(target / envl.clamp(min=1e-12),
                           max=float(np.float32(agc_max_gain)))
        audio = audio * gain

    lr = pbt_frames(audio, audio_tail, w_pbt)
    og = float(np.float32(out_gain))
    audio_l = (lr[..., :BLOCK] * og).reshape(c, n)
    audio_r = (lr[..., BLOCK:] * og).reshape(c, n)
    out = (audio_l, audio_r, audio[:, -1].contiguous(), envl[:, -1, -1].contiguous())
    return out + (nb_avg, nb_mask) if nb else out


def _bind(lib: ctypes.CDLL, nb: bool):
    ptr, i32, f32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
    if nb:
        fn = lib.sweep_chain_ssb_nb
        fn.argtypes = ([ptr] * 18 + [i32] * 3 + [f64] + [f32] * 2 + [i32]
                       + [f32] * 3 + [f64, f32, ptr])
    else:
        fn = lib.sweep_chain_ssb
        fn.argtypes = [ptr] * 14 + [i32] * 3 + [f64] + [f32] * 2 + [i32] + [f32] * 3 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def sweep_full_chain(xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i,
                     audio_tail, env0, agc_release, agc_target, agc_max_gain,
                     agc_enabled=True, out_gain=1.0, in_gain=1.0, iq_balance=1.0,
                     nb=False, nb_thresh_db=10.0, nb_tau=512.0, nb_avg0=None,
                     nb_mask0=None):
    """Whole SSB receive chain; arguments and return order as the JAX
    ``sweep_full_chain``:

      xr, xi:      (C, n) f32 planar IQ, RAW (gain and balance applied inside)
      inc, phase0: (C,) int64 DDS words in [0, 2^32)
      w_ssb:       (512, 128) ssb_demod_operator
      w_pbt:       (256, 256) pbt_operator
      tail_r/i:    (C, 128) RAW input last block of the previous segment
      audio_tail:  (C, 128) post-AGC audio tail of the previous segment
      env0:        (C,) AGC envelope carry
      nb_avg0:     (C,) blanker average carry (required with nb=True)
      nb_mask0:    (C, 128) keep mask of the previous last block (required
                   with nb=True)

    Returns (audio_l, audio_r, audio_tail_next, env_next), and with nb=True
    also (nb_avg_next, nb_mask_next). CPU tensors run the plain version; CUDA
    tensors launch the kernel, or raise.
    """
    global LAUNCHES, LAUNCHES_NB
    if xr.device.type == "cpu":
        return sweep_full_chain_plain(
            xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i, audio_tail,
            env0, agc_release, agc_target, agc_max_gain, agc_enabled,
            out_gain, in_gain, iq_balance, nb, nb_thresh_db, nb_tau, nb_avg0,
            nb_mask0)
    if xr.device.type != "cuda":
        raise ValueError(f"sweep_full_chain runs on cuda or cpu, not {xr.device}")
    _check_args(xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i,
                audio_tail, env0, agc_release, nb, nb_tau, nb_avg0, nb_mask0)
    ins = (xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i, audio_tail, env0)
    check_launch("sweep_full_chain", ins + ((nb_avg0, nb_mask0) if nb else ()))
    c, n = xr.shape
    outs = (torch.empty_like(xr), torch.empty_like(xr),
            torch.empty_like(audio_tail), torch.empty_like(env0))
    ptrs = [t.data_ptr() for t in ins + outs]
    nb_outs = ()
    if nb:
        nb_outs = (torch.empty_like(nb_avg0), torch.empty_like(nb_mask0))
        ptrs += [t.data_ptr() for t in (nb_avg0, nb_mask0) + nb_outs]
    agc = (float(agc_release), float(np.float32(agc_target)),
           float(np.float32(agc_max_gain)), int(bool(agc_enabled)),
           float(np.float32(out_gain)), float(np.float32(in_gain)),
           float(np.float32(in_gain * iq_balance)))
    nb_args = ()
    if nb:
        thresh, a = nb_constants(nb_thresh_db, nb_tau)
        nb_args = (a, float(np.float32(thresh)))
    fn = _bind(build.load_library("sweep_chain"), nb)
    stream = torch.cuda.current_stream(xr.device).cuda_stream
    err = fn(*ptrs, c, n, xr.device.index or 0, *agc, *nb_args, stream)
    if err:
        kernel = "sweep_chain_ssb_nb" if nb else "sweep_chain_ssb"
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    if nb:
        LAUNCHES_NB += 1
    else:
        LAUNCHES += 1
    return outs + nb_outs
