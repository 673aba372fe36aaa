"""The whole SSB receive chain in one kernel launch.

Counterpart of ``radiodsp_sdr_rx_tpu/ops/pallas_sweep.py``: ``sweep_full_chain``
(:628) and the ``demod="ssb"`` variant of its kernel ``_chain_kernel`` (:261).
Per channel, in this order:

  input gain / IQ balance -> DDS NCO mix -> overlap-save band-pass + SSB demod
  as (rows,512)@(512,128) -> AGC env[k] = max(|a[k]|, env[k-1]*release),
  gain = min(target/max(env, 1e-12), max_gain) -> PBT (rows,256)@(256,256)
  giving [L|R] -> output gain.

The framing tail (the RAW previous block, re-scaled and re-mixed at positions
-128..-1), the AGC envelope and the PBT tail carry from segment to segment.

``sweep_full_chain`` launches ``csrc/sweep_chain.cu`` for CUDA tensors and
raises if it cannot; for CPU tensors it runs ``sweep_full_chain_plain``, the
plain PyTorch version the tests and ``chip_smoke.py`` hold the kernel to.
``LAUNCHES`` counts the kernel's launches. The JAX wrapper's TPU tiling knobs
(``block_c``, ``chunk_t``, ``interpret``) have no meaning here and are not
taken; the noise-blanker variant and ``emit_r=False`` come with a later slice.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.utils import build

_PHASE_SCALE = np.float32(2.0 * np.pi / 4294967296.0)
_BLOCK = 128

LAUNCHES = 0


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


def _mix(xr, xi, phase0, inc, positions, g_i, g_q):
    """Scale and mix down by the DDS phase phase0 + position*inc (uint32 wrap),
    read as int32 before the float conversion, as the TPU kernel does."""
    phase = (phase0[:, None] + positions[None, :] * inc[:, None]) & 0xFFFFFFFF
    phase = torch.where(phase >= 1 << 31, phase - (1 << 32), phase)
    ang = phase.to(torch.int32).to(torch.float32) * float(_PHASE_SCALE)
    c, s = torch.cos(ang), torch.sin(ang)
    xr = xr * g_i
    xi = xi * g_q
    return xr * c + xi * s, xi * c - xr * s


def _check_args(xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i,
                audio_tail, env0, agc_release):
    if xr.dim() != 2 or xr.shape[1] == 0 or xr.shape[1] % _BLOCK:
        raise ValueError(f"xr must be (C, n) with n a positive multiple of "
                         f"{_BLOCK}, got {tuple(xr.shape)}")
    if not 0.0 < agc_release <= 1.0:
        raise ValueError(f"agc_release must be in (0, 1], got {agc_release}")
    c, n = xr.shape
    expect = {"xi": (xi, (c, n), torch.float32),
              "inc": (inc, (c,), torch.int64),
              "phase0": (phase0, (c,), torch.int64),
              "w_ssb": (w_ssb, (512, 128), torch.float32),
              "w_pbt": (w_pbt, (256, 256), torch.float32),
              "tail_r": (tail_r, (c, _BLOCK), torch.float32),
              "tail_i": (tail_i, (c, _BLOCK), torch.float32),
              "audio_tail": (audio_tail, (c, _BLOCK), torch.float32),
              "env0": (env0, (c,), torch.float32),
              "xr": (xr, (c, n), torch.float32)}
    for name, (t, shape, dtype) in expect.items():
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != xr.device:
            raise ValueError(f"{name}: expected {dtype} {shape} on {xr.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def sweep_full_chain_plain(xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i,
                           audio_tail, env0, agc_release, agc_target,
                           agc_max_gain, agc_enabled=True, out_gain=1.0,
                           in_gain=1.0, iq_balance=1.0):
    """Plain PyTorch version of the chain, vectorised over the whole segment.

    The AGC runs as the TPU kernel's doubling scans (``_env_lanes`` within a
    128-sample row, ``_env_rows`` across rows) plus the row carry, with no
    per-sample loop. Both products are fp32; on a CUDA tensor TF32 is switched
    off (``torch.backends.cuda.matmul.allow_tf32 = False``) so that the card
    computes them in full fp32 as the kernel does.
    """
    _check_args(xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i,
                audio_tail, env0, agc_release)
    if xr.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    c, n = xr.shape
    rows = n // _BLOCK
    g_i = float(np.float32(in_gain))
    g_q = float(np.float32(in_gain * iq_balance))
    pos = torch.arange(n, dtype=torch.int64, device=xr.device)
    br, bi = _mix(xr, xi, phase0, inc, pos, g_i, g_q)
    tr, ti = _mix(tail_r, tail_i, phase0, inc, pos[:_BLOCK] - _BLOCK, g_i, g_q)

    br = br.view(c, rows, _BLOCK)
    bi = bi.view(c, rows, _BLOCK)
    prev_r = torch.cat([tr[:, None], br[:, :-1]], dim=1)
    prev_i = torch.cat([ti[:, None], bi[:, :-1]], dim=1)
    audio = torch.matmul(torch.cat([prev_r, br, prev_i, bi], dim=-1), w_ssb)
    del br, bi, prev_r, prev_i

    run_e = _env_lanes(audio.abs(), agc_release)
    seq_e = torch.cat([env0[:, None], run_e[:, :-1, -1]], dim=1)
    carry_e = _env_rows(seq_e, float(np.float64(agc_release) ** _BLOCK))
    lane1 = torch.arange(1, _BLOCK + 1, dtype=torch.float32, device=xr.device)
    r_lane = (torch.exp(float(np.float32(np.log(agc_release))) * lane1)
              if agc_release < 1.0 else torch.ones_like(lane1))
    envl = torch.maximum(run_e, carry_e[:, :, None] * r_lane)
    if agc_enabled:
        target = torch.tensor(float(np.float32(agc_target)), device=xr.device)
        gain = torch.clamp(target / envl.clamp(min=1e-12),
                           max=float(np.float32(agc_max_gain)))
        audio = audio * gain

    prev_a = torch.cat([audio_tail[:, None], audio[:, :-1]], dim=1)
    lr = torch.matmul(torch.cat([prev_a, audio], dim=-1), w_pbt)
    og = float(np.float32(out_gain))
    audio_l = (lr[..., :_BLOCK] * og).reshape(c, n)
    audio_r = (lr[..., _BLOCK:] * og).reshape(c, n)
    return audio_l, audio_r, audio[:, -1].contiguous(), envl[:, -1, -1].contiguous()


def _bind(lib: ctypes.CDLL):
    fn = lib.sweep_chain_ssb
    fn.argtypes = ([ctypes.c_void_p] * 14
                   + [ctypes.c_int] * 3 + [ctypes.c_double]
                   + [ctypes.c_float] * 2 + [ctypes.c_int]
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def sweep_full_chain(xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i,
                     audio_tail, env0, agc_release, agc_target, agc_max_gain,
                     agc_enabled=True, out_gain=1.0, in_gain=1.0, iq_balance=1.0):
    """Whole SSB receive chain; arguments and return order as the JAX
    ``sweep_full_chain``:

      xr, xi:      (C, n) f32 planar IQ, RAW (gain and balance applied inside)
      inc, phase0: (C,) int64 DDS words in [0, 2^32)
      w_ssb:       (512, 128) ssb_demod_operator
      w_pbt:       (256, 256) pbt_operator
      tail_r/i:    (C, 128) RAW input last block of the previous segment
      audio_tail:  (C, 128) post-AGC audio tail of the previous segment
      env0:        (C,) AGC envelope carry

    Returns (audio_l, audio_r, audio_tail_next, env_next). CPU tensors run the
    plain version; CUDA tensors launch the kernel, or raise.
    """
    global LAUNCHES
    if xr.device.type == "cpu":
        return sweep_full_chain_plain(
            xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i, audio_tail,
            env0, agc_release, agc_target, agc_max_gain, agc_enabled,
            out_gain, in_gain, iq_balance)
    if xr.device.type != "cuda":
        raise ValueError(f"sweep_full_chain runs on cuda or cpu, not {xr.device}")
    _check_args(xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i,
                audio_tail, env0, agc_release)
    ins = (xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i, audio_tail, env0)
    for t in ins:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("sweep_full_chain takes contiguous tensors "
                             "aligned to 16 bytes")
    c, n = xr.shape
    audio_l = torch.empty_like(xr)
    audio_r = torch.empty_like(xr)
    atail = torch.empty_like(audio_tail)
    env = torch.empty_like(env0)
    fn = _bind(build.load_library("sweep_chain"))
    stream = torch.cuda.current_stream(xr.device).cuda_stream
    err = fn(*(t.data_ptr() for t in ins + (audio_l, audio_r, atail, env)),
             c, n, xr.device.index or 0, float(agc_release), float(np.float32(agc_target)),
             float(np.float32(agc_max_gain)), int(bool(agc_enabled)),
             float(np.float32(out_gain)), float(np.float32(in_gain)),
             float(np.float32(in_gain * iq_balance)), stream)
    if err:
        raise RuntimeError(f"sweep_chain_ssb launch failed: cudaError {err}")
    LAUNCHES += 1
    return audio_l, audio_r, atail, env
