"""The SSB receive chain with spectral-subtraction NR in one kernel launch (K4).

Counterpart of ``radiodsp_sdr_rx_tpu/ops/pallas_sweep_spec.py``:
``sweep_spec_chain`` (:246), kernel ``_spec_chain_kernel`` (:46). Per channel,
the SSB chain of ``ops/sweep.sweep_full_chain`` (input gain / IQ balance, DDS
mix, band-pass + SSB demod, AGC, PBT -> [l | r]), then per 128-sample row the
spectral subtraction of ``ops/spectral_sub.py``:

  [prev_l | l | prev_r | r] (rows,512) @ W_fwd (512,512) -> [sr | si],
  mag = sqrt(sr^2 + si^2), floor_est = sum of mag over bins 30..180 *
  level*1.5/150, nf[j] = 0.35 nf[j-1] + 0.65 floor_est[j] across rows and
  segments, scale = 0.2 where mag <= max(nf, 0) else 1 - nf/max(mag, 1e-20),
  [sr*scale | si*scale] (rows,512) @ W_inv (512,256) -> [L | R], output gain.

Carries: the RAW input's last block, the PBT tail, the AGC envelope, the
floor (unclamped) and the last post-PBT blocks of l and r.

``sweep_spec_chain`` launches ``csrc/sweep_spec.cu`` for CUDA tensors or
raises; for CPU tensors it runs ``sweep_spec_chain_plain``, the plain
PyTorch version the tests and ``chip_smoke.py`` hold the kernel to.
``LAUNCHES`` counts the launches. The JAX wrapper's TPU tiling and precision
knobs (``block_c``, ``chunk_t``, ``interpret``, ``precision``) have no
meaning here and are not taken; every product is full fp32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.ops import sweep
from radiodsp_sdr_rx_tpu_torch.ops.chain_common import (
    BLOCK,
    check_launch,
    check_tensors,
    matmul_fp32,
)
from radiodsp_sdr_rx_tpu_torch.ops.spectral_sub import (
    UNDER_FLOOR_GAIN,
    VAD_END_BIN,
    VAD_START_BIN,
    floor_track,
)
from radiodsp_sdr_rx_tpu_torch.utils import build

LAUNCHES = 0   # sweep_spec_chain


def nr_gain(nr_level) -> float:
    """The per-frame floor multiplier level * 1.5 / 150 as an f32 value: the
    mean over the VAD band divides its 151-bin sum by 150, the reference's
    own off-by-one (RDSP_convolutional_spec.h:200)."""
    return float(np.float32(float(nr_level) * 1.5 / float(VAD_END_BIN - VAD_START_BIN)))


def _check_args(xr, xi, inc, phase0, w_ssb, w_pbt, w_spec_fwd, w_spec_inv, tail_r, tail_i,
                audio_tail, env0, nfloor0, spec_tail_l, spec_tail_r, agc_release):
    sweep.check_chain_args(xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i, audio_tail,
                           env0, agc_release, nb=False, nb_tau=1.0, nb_avg0=None,
                           nb_mask0=None)
    c = xr.shape[0]
    f32 = torch.float32
    check_tensors({"w_spec_fwd": (w_spec_fwd, (512, 512), f32),
                   "w_spec_inv": (w_spec_inv, (512, 256), f32),
                   "nfloor0": (nfloor0, (c,), f32),
                   "spec_tail_l": (spec_tail_l, (c, BLOCK), f32),
                   "spec_tail_r": (spec_tail_r, (c, BLOCK), f32)}, xr.device)


def spectral_floor(l, r, w_spec_fwd, nfloor0, spec_tail_l, spec_tail_r, nr_level):
    """The spectral stage's spectrum and floor for the post-PBT l, r (C, n),
    as the plain version computes them: (sr, si, mag), each (C, rows, 256),
    and the floor per row (C, rows), unclamped. ``chip_smoke.py`` reads the
    distance of each bin from the floor here: a bin within rounding of it
    takes the scale 0.2 or about 0 depending on the summation order."""
    c, n = l.shape
    l3, r3 = l.view(c, n // BLOCK, BLOCK), r.view(c, n // BLOCK, BLOCK)
    prev_l = torch.cat([spec_tail_l[:, None], l3[:, :-1]], dim=1)
    prev_r = torch.cat([spec_tail_r[:, None], r3[:, :-1]], dim=1)
    spec = matmul_fp32(torch.cat([prev_l, l3, prev_r, r3], dim=-1), w_spec_fwd)
    del prev_l, prev_r
    sr, si = spec[..., :2 * BLOCK], spec[..., 2 * BLOCK:]
    mag = torch.sqrt(sr * sr + si * si)
    floor_est = mag[..., VAD_START_BIN:VAD_END_BIN + 1].sum(-1) * nr_gain(nr_level)
    return sr, si, mag, floor_track(floor_est, nfloor0)


def sweep_spec_chain_plain(xr, xi, inc, phase0, w_ssb, w_pbt, w_spec_fwd, w_spec_inv,
                           tail_r, tail_i, audio_tail, env0, nfloor0, spec_tail_l,
                           spec_tail_r, nr_level, agc_release, agc_target, agc_max_gain,
                           agc_enabled=True, out_gain=1.0, in_gain=1.0, iq_balance=1.0):
    """Plain PyTorch version of ``sweep_spec_chain``: the plain SSB chain with
    unit output gain, then the spectral stage over the whole segment, the
    floor as a doubling scan across its rows from the carry."""
    _check_args(xr, xi, inc, phase0, w_ssb, w_pbt, w_spec_fwd, w_spec_inv, tail_r, tail_i,
                audio_tail, env0, nfloor0, spec_tail_l, spec_tail_r, agc_release)
    l, r, atail, env = sweep.sweep_full_chain_plain(
        xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i, audio_tail, env0,
        agc_release, agc_target, agc_max_gain, agc_enabled, 1.0, in_gain, iq_balance)
    c, n = l.shape
    sr, si, mag, nfloor = spectral_floor(l, r, w_spec_fwd, nfloor0, spec_tail_l, spec_tail_r,
                                         nr_level)
    nf = nfloor.clamp(min=0.0)[..., None]
    scale = torch.where(mag <= nf, UNDER_FLOOR_GAIN, 1.0 - nf / mag.clamp(min=1e-20))
    del mag
    y = matmul_fp32(torch.cat([sr * scale, si * scale], dim=-1), w_spec_inv)
    del sr, si, scale
    og = float(np.float32(out_gain))
    return ((y[..., :BLOCK] * og).reshape(c, n), (y[..., BLOCK:] * og).reshape(c, n),
            atail, env, nfloor[:, -1].contiguous(), l[:, -BLOCK:].contiguous(),
            r[:, -BLOCK:].contiguous())


_PTR, _I32, _F32, _F64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
_ARGTYPES = ([_PTR] * 22 + [_I32] * 3 + [_F64] + [_F32] * 2 + [_I32] + [_F32] * 4
             + [_PTR])   # the extern "C" sweep_spec_chain of csrc/sweep_spec.cu


def sweep_spec_chain(xr, xi, inc, phase0, w_ssb, w_pbt, w_spec_fwd, w_spec_inv,
                     tail_r, tail_i, audio_tail, env0, nfloor0, spec_tail_l, spec_tail_r,
                     nr_level, agc_release, agc_target, agc_max_gain, agc_enabled=True,
                     out_gain=1.0, in_gain=1.0, iq_balance=1.0):
    """Whole SSB + spectral-subtraction receive chain; arguments and returns
    as the JAX ``sweep_spec_chain``:

      xr, xi ... env0:  as ``ops/sweep.sweep_full_chain`` (RAW input, RAW tails)
      w_spec_fwd:       (512, 512) spectral_sub.spectral_matmul_ops forward DFT
      w_spec_inv:       (512, 256) its right-half inverse
      nfloor0:          (C,) noise-floor carry (zeros at stream start)
      spec_tail_l/r:    (C, 128) the previous post-PBT block of l and r
      nr_level:         subtraction strength (20/30/40/50 for SPEC1-4)

    Returns (audio_l, audio_r, audio_tail', env', nfloor', spec_tail_l',
    spec_tail_r'). CPU tensors run the plain version; CUDA tensors launch the
    kernel, or raise. The kernel takes W_fwd with its columns regrouped by
    bin halves, which this wrapper makes (one 1 MB copy per call).
    """
    global LAUNCHES
    args = (xr, xi, inc, phase0, w_ssb, w_pbt, w_spec_fwd, w_spec_inv, tail_r, tail_i,
            audio_tail, env0, nfloor0, spec_tail_l, spec_tail_r, nr_level, agc_release,
            agc_target, agc_max_gain, agc_enabled, out_gain, in_gain, iq_balance)
    if xr.device.type == "cpu":
        return sweep_spec_chain_plain(*args)
    if xr.device.type != "cuda":
        raise ValueError(f"sweep_spec_chain runs on cuda or cpu, not {xr.device}")
    _check_args(*args[:15], agc_release)
    check_launch("sweep_spec_chain", args[:15])
    # columns [sr 0..255 | si 0..255] -> two (512, 256) passes [sr | si] of
    # bins 0..127 and of bins 128..255
    w_fwd2 = w_spec_fwd.view(512, 2, 2, BLOCK).permute(2, 0, 1, 3).contiguous()
    ins = args[:6] + (w_fwd2,) + args[7:15]
    c, n = xr.shape
    outs = (torch.empty_like(xr), torch.empty_like(xr), torch.empty_like(audio_tail),
            torch.empty_like(env0), torch.empty_like(nfloor0), torch.empty_like(spec_tail_l),
            torch.empty_like(spec_tail_r))
    fn = build.load_library("sweep_spec").sweep_spec_chain
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(*(t.data_ptr() for t in ins + outs), c, n, xr.device.index or 0, float(agc_release),
             float(np.float32(agc_target)), float(np.float32(agc_max_gain)),
             int(bool(agc_enabled)), float(np.float32(out_gain)), float(np.float32(in_gain)),
             float(np.float32(in_gain * iq_balance)), nr_gain(nr_level),
             torch.cuda.current_stream(xr.device).cuda_stream)
    if err:
        raise RuntimeError(f"sweep_spec_chain launch failed: cudaError {err}")
    LAUNCHES += 1
    return outs
