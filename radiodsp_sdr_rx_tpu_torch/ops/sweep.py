"""The whole receive chain in one kernel launch: SSB, AM and SAM.

Counterpart of ``radiodsp_sdr_rx_tpu/ops/pallas_sweep.py``: ``sweep_full_chain``
(:628) and ``sweep_am_chain`` (:695), the ``demod="ssb"`` and ``demod="am"``
variants of its kernel ``_chain_kernel`` (:261); and ``sweep_sam_chain``,
the ``demod="sam", nr="none"`` variant of ``ops/pallas_chain_lanes.py``'s
``sweep_lanes_chain`` (:748, kernel ``_lanes_chain_kernel`` :98). Per
channel, in this order:

  input gain / IQ balance -> [nb=True: noise blanker] -> DDS NCO mix ->
  ssb: overlap-save band-pass + SSB demod as (rows,512)@(512,128);
  am:  complex band-pass (rows,512)@(512,256) -> envelope sqrt(zr^2+zi^2)
       -> DC blocker y[n] = env[n] - env[n-1] + pole*y[n-1] ->
  sam: the same band-pass -> the carrier PLL (ops/sam.py) -> its in-phase
       product through the same DC blocker ->
  AGC env[k] = max(|a[k]|, env[k-1]*release),
  gain = min(target/max(env, 1e-12), max_gain) -> PBT (rows,256)@(256,256)
  giving [L|R] -> output gain.

The framing tail (the RAW previous block, re-scaled and re-mixed at positions
-128..-1), the AGC envelope and the PBT tail carry from segment to segment;
the AM chain also carries the DC blocker's [last envelope, last output]
(C, 2), and SAM the PLL's (2, C) [phase | freq] rows; the PLL re-seeds
where the ``reseed`` argument says (``sam.Reseed``). The noise blanker
(``pallas_sweep.py:386-403``) zeroes every scaled sample whose magnitude
exceeds avg*10^(dB/20) + 1e-12, with avg the one-pole mean of the magnitude
(a = exp(-1/tau)); its average and the last block's keep mask carry too, and
the mask gates the re-mixed tail.

``sweep_full_chain`` and ``sweep_am_chain`` launch ``csrc/sweep_chain.cu``
for CUDA tensors (``sweep_chain_ssb``, ``sweep_chain_ssb_nb``,
``sweep_chain_am``, ``sweep_chain_am_nb``), ``sweep_sam_chain`` launches
``sweep_chain_sam`` or ``sweep_chain_sam_nb``, and they raise if they cannot;
for CPU tensors they run ``sweep_full_chain_plain`` / ``sweep_am_chain_plain``
/ ``sweep_sam_chain_plain``, the plain PyTorch versions the tests and
``chip_smoke.py`` hold the kernels to. ``sweep_full_chain(..., emit_r=False)``
(the SSB chain without the blanker) returns R as ``None``: the kernel
``sweep_chain_ssb_mono`` neither computes R into the output nor stores it.
``LAUNCHES``, ``LAUNCHES_NB``, ``LAUNCHES_AM``, ``LAUNCHES_AM_NB``,
``LAUNCHES_MONO``, ``LAUNCHES_SAM`` and ``LAUNCHES_SAM_NB`` count the seven
kernels' launches. The JAX wrappers' TPU tiling knobs (``block_c``,
``chunk_t``, ``interpret``) have no meaning here and are not taken.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.ops import sam as sam_ops
from radiodsp_sdr_rx_tpu_torch.ops.chain_common import (
    BLOCK,
    check_launch,
    check_stream,
    check_tensors,
    demod_frames,
    iir_rows,
    mix,
    pbt_frames,
)
from radiodsp_sdr_rx_tpu_torch.ops.iir import DC_POLE
from radiodsp_sdr_rx_tpu_torch.utils import build

LAUNCHES = 0        # sweep_chain_ssb
LAUNCHES_NB = 0     # sweep_chain_ssb_nb
LAUNCHES_AM = 0     # sweep_chain_am
LAUNCHES_AM_NB = 0  # sweep_chain_am_nb
LAUNCHES_MONO = 0   # sweep_chain_ssb_mono
LAUNCHES_SAM = 0    # sweep_chain_sam
LAUNCHES_SAM_NB = 0  # sweep_chain_sam_nb


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
    decaying-sum doubling scans (``_iir_lanes`` within a row, ``iir_rows``
    across rows), samples above avg*thresh + 1e-12 zeroed. Returns
    (xr, xi, avg at the last sample, keep mask of the last row)."""
    thresh, a = nb_constants(nb_thresh_db, nb_tau)
    c, n = xr.shape
    xr = xr.view(c, n // BLOCK, BLOCK)
    xi = xi.view(c, n // BLOCK, BLOCK)
    mag = torch.sqrt(xr * xr + xi * xi)
    run = _iir_lanes(mag * float(np.float32(1.0 - a)), a)
    seq = torch.cat([avg0[:, None], run[:, :-1, -1]], dim=1)
    carry = iir_rows(seq, float(np.float64(a) ** BLOCK))
    avg = run + carry[:, :, None] * _lane_decay(a, xr.device)
    keep = mag <= avg * float(np.float32(thresh)) + 1e-12
    xr = torch.where(keep, xr, 0.0).view(c, n)
    xi = torch.where(keep, xi, 0.0).view(c, n)
    return xr, xi, avg[:, -1, -1].contiguous(), keep[:, -1].to(torch.float32)


def check_chain_args(xr, xi, inc, phase0, w, w_pbt, tail_r, tail_i, audio_tail,
                env0, agc_release, nb, nb_tau, nb_avg0, nb_mask0, dc0=None, emit_r=True,
                pll0=None):
    """Raise ValueError on arguments the chain does not take; ``dc0`` given
    means the AM or (``pll0`` given too) the SAM chain: w is then (512, 256)."""
    check_stream(xr)
    if not 0.0 < agc_release <= 1.0:
        raise ValueError(f"agc_release must be in (0, 1], got {agc_release}")
    if not emit_r and (nb or dc0 is not None):
        raise ValueError("emit_r=False is the SSB chain without the blanker "
                         "(FusedNRBank(fold=False)'s DNR route)")
    c, n = xr.shape
    f32 = torch.float32
    expect = {"xi": (xi, (c, n), f32),
              "inc": (inc, (c,), torch.int64),
              "phase0": (phase0, (c,), torch.int64),
              "w_pbt": (w_pbt, (256, 256), f32),
              "tail_r": (tail_r, (c, BLOCK), f32),
              "tail_i": (tail_i, (c, BLOCK), f32),
              "audio_tail": (audio_tail, (c, BLOCK), f32),
              "env0": (env0, (c,), f32),
              "xr": (xr, (c, n), f32)}
    if dc0 is None:
        expect["w_ssb"] = (w, (512, 128), f32)
    else:
        expect["w_sb"] = (w, (512, 256), f32)
        expect["dc0"] = (dc0, (c, 2), f32)
    if pll0 is not None:
        expect["pll0"] = (pll0, (2, c), f32)
    if nb:
        if not nb_tau > 0.0:
            raise ValueError(f"nb_tau must be positive, got {nb_tau}")
        if nb_avg0 is None or nb_mask0 is None:
            raise ValueError("nb=True takes the blanker's carries nb_avg0 and "
                             "nb_mask0 (the banks' init_state gives them at "
                             "stream start)")
        expect["nb_avg0"] = (nb_avg0, (c,), f32)
        expect["nb_mask0"] = (nb_mask0, (c, BLOCK), f32)
    check_tensors(expect, xr.device)


def _dc_block(env, dc0):
    """The DC blocker on the demodulated rows env (C, rows, 128), as the TPU
    kernel's decaying-sum doubling scans (within a row, then across rows)
    plus the row carry. Returns (audio (C, rows, 128), dc' (C, 2))."""
    c, rows, _ = env.shape
    prev = torch.cat([dc0[:, :1], env.reshape(c, -1)[:, :-1]], dim=1)
    run = _iir_lanes(env - prev.view(c, rows, BLOCK), DC_POLE)
    seq = torch.cat([dc0[:, 1:2], run[:, :-1, -1]], dim=1)
    carry = iir_rows(seq, float(np.float64(DC_POLE) ** BLOCK))
    audio = run + carry[:, :, None] * _lane_decay(DC_POLE, env.device)
    return audio, torch.stack([env[:, -1, -1], audio[:, -1, -1]], dim=-1)


class SamArgs(NamedTuple):
    """What the SAM chain adds to the AM chain's arguments."""

    pll0: torch.Tensor        # (2, C) [phase | freq]
    gains: sam_ops.PllGains
    reseed: sam_ops.Reseed


def chain_plain(xr, xi, inc, phase0, w, w_pbt, tail_r, tail_i, audio_tail,
                env0, agc_release, agc_target, agc_max_gain, agc_enabled,
                out_gain, in_gain, iq_balance, nb, nb_thresh_db, nb_tau,
                nb_avg0, nb_mask0, dc0=None, emit_r=True, sam: SamArgs | None = None):
    """The plain chain, SSB, (``dc0`` given) AM or (``sam`` given too) SAM,
    vectorised over the whole segment but for the SAM PLL (one step per
    sample, ``sam.pll_loop``): the AGC, the blanker's average and the DC
    blocker run as the TPU kernel's doubling scans (within a 128-sample row,
    then across rows) plus the row carry. Both products are full fp32
    (``chain_common.matmul_fp32``), as the kernels compute them; without
    ``emit_r`` R is computed and dropped, so L is the emit_r=True L."""
    check_chain_args(xr, xi, inc, phase0, w, w_pbt, tail_r, tail_i, audio_tail,
                env0, agc_release, nb, nb_tau, nb_avg0, nb_mask0, dc0, emit_r,
                None if sam is None else sam.pll0)
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
    y = demod_frames(br, bi, tr, ti, w)
    del br, bi
    if sam is not None:
        rows = n // BLOCK
        vr, phase, freq = sam_ops.pll_loop(
            y[..., :BLOCK].reshape(c, n), y[..., BLOCK:].reshape(c, n),
            sam.pll0[0], sam.pll0[1], sam.gains, sam.reseed)
        audio, dc = _dc_block(vr.view(c, rows, BLOCK), dc0)
        pll = torch.stack([phase, freq])
    elif dc0 is not None:
        audio, dc = _dc_block(torch.sqrt(y[..., :BLOCK].square() + y[..., BLOCK:].square()),
                              dc0)
    else:
        audio = y
    del y

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
    audio_r = (lr[..., BLOCK:] * og).reshape(c, n) if emit_r else None
    out = (audio_l, audio_r, audio[:, -1].contiguous(), envl[:, -1, -1].contiguous())
    if dc0 is not None:
        out += (dc,)
    if sam is not None:
        out += (pll,)
    return out + (nb_avg, nb_mask) if nb else out


def sweep_full_chain_plain(xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i,
                           audio_tail, env0, agc_release, agc_target,
                           agc_max_gain, agc_enabled=True, out_gain=1.0,
                           in_gain=1.0, iq_balance=1.0, nb=False,
                           nb_thresh_db=10.0, nb_tau=512.0, nb_avg0=None,
                           nb_mask0=None, emit_r=True):
    """Plain PyTorch version of ``sweep_full_chain``."""
    return chain_plain(xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i,
                       audio_tail, env0, agc_release, agc_target, agc_max_gain,
                       agc_enabled, out_gain, in_gain, iq_balance, nb,
                       nb_thresh_db, nb_tau, nb_avg0, nb_mask0, emit_r=emit_r)


def sweep_am_chain_plain(xr, xi, inc, phase0, w_sb, w_pbt, tail_r, tail_i,
                         audio_tail, env0, dc0, agc_release, agc_target,
                         agc_max_gain, agc_enabled=True, out_gain=1.0,
                         in_gain=1.0, iq_balance=1.0, nb=False,
                         nb_thresh_db=10.0, nb_tau=512.0, nb_avg0=None,
                         nb_mask0=None):
    """Plain PyTorch version of ``sweep_am_chain``."""
    return chain_plain(xr, xi, inc, phase0, w_sb, w_pbt, tail_r, tail_i,
                       audio_tail, env0, agc_release, agc_target, agc_max_gain,
                       agc_enabled, out_gain, in_gain, iq_balance, nb,
                       nb_thresh_db, nb_tau, nb_avg0, nb_mask0, dc0)


_PTR, _I32, _F32, _F64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
_ARGTYPES = {  # the extern "C" launchers of csrc/sweep_chain.cu
    "sweep_chain_ssb": [_PTR] * 14 + [_I32] * 3 + [_F64] + [_F32] * 2 + [_I32]
                       + [_F32] * 3 + [_PTR],
    "sweep_chain_ssb_nb": [_PTR] * 18 + [_I32] * 3 + [_F64] + [_F32] * 2 + [_I32]
                          + [_F32] * 3 + [_F64, _F32, _PTR],
    "sweep_chain_am": [_PTR] * 16 + [_I32] * 3 + [_F64] + [_F32] * 2 + [_I32]
                      + [_F32] * 3 + [_PTR],
    "sweep_chain_am_nb": [_PTR] * 20 + [_I32] * 3 + [_F64] + [_F32] * 2 + [_I32]
                         + [_F32] * 3 + [_F64, _F32, _PTR],
    "sweep_chain_ssb_mono": [_PTR] * 13 + [_I32] * 3 + [_F64] + [_F32] * 2 + [_I32]
                            + [_F32] * 3 + [_PTR],
    "sweep_chain_sam": [_PTR] * 18 + [_I32] * 3 + [_F64] + [_F32] * 2 + [_I32]
                       + [_F32] * 6 + [_I32] * 3 + [_PTR],
    "sweep_chain_sam_nb": [_PTR] * 22 + [_I32] * 3 + [_F64] + [_F32] * 2 + [_I32]
                          + [_F32] * 3 + [_F64] + [_F32] * 4 + [_I32] * 3 + [_PTR],
    # csrc/sam_wide.cu: the same with the groups after the device
    "sam_wide": [_PTR] * 18 + [_I32] * 4 + [_F64] + [_F32] * 2 + [_I32]
                + [_F32] * 6 + [_I32] * 3 + [_PTR],
    "sam_wide_nb": [_PTR] * 22 + [_I32] * 4 + [_F64] + [_F32] * 2 + [_I32]
                   + [_F32] * 3 + [_F64] + [_F32] * 4 + [_I32] * 3 + [_PTR],
}


_COUNTERS = {"sweep_chain_ssb": "LAUNCHES", "sweep_chain_ssb_nb": "LAUNCHES_NB",
             "sweep_chain_am": "LAUNCHES_AM", "sweep_chain_am_nb": "LAUNCHES_AM_NB",
             "sweep_chain_ssb_mono": "LAUNCHES_MONO", "sweep_chain_sam": "LAUNCHES_SAM",
             "sweep_chain_sam_nb": "LAUNCHES_SAM_NB"}


def launch_chain(xr, xi, inc, phase0, w, w_pbt, tail_r, tail_i, audio_tail,
                 env0, agc_release, agc_target, agc_max_gain, agc_enabled,
                 out_gain, in_gain, iq_balance, nb, nb_thresh_db, nb_tau,
                 nb_avg0, nb_mask0, dc0=None, emit_r=True, sam: SamArgs | None = None,
                 groups: int | None = None):
    """Check, allocate the outputs and launch one of the seven kernels of
    ``csrc/sweep_chain.cu``, or with ``groups`` the SAM chain of
    ``csrc/sam_wide.cu`` (its caller counts that launch); returns the outputs
    in the order of the plain version's return."""
    if xr.device.type != "cuda":
        raise ValueError(f"the sweep chain runs on cuda or cpu, not {xr.device}")
    am = dc0 is not None
    check_chain_args(xr, xi, inc, phase0, w, w_pbt, tail_r, tail_i, audio_tail,
                env0, agc_release, nb, nb_tau, nb_avg0, nb_mask0, dc0, emit_r,
                None if sam is None else sam.pll0)
    ins = (xr, xi, inc, phase0, w, w_pbt, tail_r, tail_i, audio_tail, env0)
    ins += (dc0,) if am else ()
    ins += (sam.pll0,) if sam else ()
    nb_ins = (nb_avg0, nb_mask0) if nb else ()
    check_launch("the sweep chain", ins + nb_ins)
    c, n = xr.shape
    outs = (torch.empty_like(xr), torch.empty_like(xr) if emit_r else None,
            torch.empty_like(audio_tail), torch.empty_like(env0))
    outs += (torch.empty_like(dc0),) if am else ()
    outs += (torch.empty_like(sam.pll0),) if sam else ()
    nb_outs = (torch.empty_like(nb_avg0), torch.empty_like(nb_mask0)) if nb else ()
    agc = (float(agc_release), float(np.float32(agc_target)),
           float(np.float32(agc_max_gain)), int(bool(agc_enabled)),
           float(np.float32(out_gain)), float(np.float32(in_gain)),
           float(np.float32(in_gain * iq_balance)))
    nb_args = ()
    if nb:
        thresh, a = nb_constants(nb_thresh_db, nb_tau)
        nb_args = (a, float(np.float32(thresh)))
    demod = "sam" if sam else "am" if am else "ssb"
    name = f"sweep_chain_{demod}{'_nb' if nb else ''}{'' if emit_r else '_mono'}"
    lib, dims = "sweep_chain", (c, n, xr.device.index or 0)
    pll_consts = ()
    if sam:
        pll_consts = (*sam.gains, *sam.reseed)
        if groups is not None:
            lib, name, dims = "sam_wide", f"sam_wide{'_nb' if nb else ''}", dims + (groups,)
    fn = getattr(build.load_library(lib), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(xr.device).cuda_stream
    err = fn(*(t.data_ptr() for t in ins + outs + nb_ins + nb_outs if t is not None), *dims,
             *agc, *nb_args, *pll_consts, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    if name in _COUNTERS:   # sam_wide's caller counts its launches
        globals()[_COUNTERS[name]] += 1
    return outs + nb_outs


def sweep_full_chain(xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i,
                     audio_tail, env0, agc_release, agc_target, agc_max_gain,
                     agc_enabled=True, out_gain=1.0, in_gain=1.0, iq_balance=1.0,
                     nb=False, nb_thresh_db=10.0, nb_tau=512.0, nb_avg0=None,
                     nb_mask0=None, emit_r=True):
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
    also (nb_avg_next, nb_mask_next); audio_r is None with emit_r=False (not
    taken with nb=True). CPU tensors run the plain version; CUDA tensors
    launch the kernel, or raise.
    """
    run = sweep_full_chain_plain if xr.device.type == "cpu" else launch_chain
    return run(xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i, audio_tail,
               env0, agc_release, agc_target, agc_max_gain, agc_enabled,
               out_gain, in_gain, iq_balance, nb, nb_thresh_db, nb_tau,
               nb_avg0, nb_mask0, emit_r=emit_r)


def sweep_am_chain(xr, xi, inc, phase0, w_sb, w_pbt, tail_r, tail_i,
                   audio_tail, env0, dc0, agc_release, agc_target, agc_max_gain,
                   agc_enabled=True, out_gain=1.0, in_gain=1.0, iq_balance=1.0,
                   nb=False, nb_thresh_db=10.0, nb_tau=512.0,
                   nb_avg0=None, nb_mask0=None):
    """Whole AM receive chain; arguments as ``sweep_full_chain``, plus:

      w_sb:  (512, 256) overlap_save_matrix_real, the complex band-pass
      dc0:   (C, 2) DC-blocker carry [last envelope, last output] (zeros at
             stream start)

    Returns (audio_l, audio_r, audio_tail_next, env_next, dc_next), and with
    nb=True also (nb_avg_next, nb_mask_next). CPU tensors run the plain
    version; CUDA tensors launch the kernel, or raise.
    """
    if xr.device.type == "cpu":
        return sweep_am_chain_plain(xr, xi, inc, phase0, w_sb, w_pbt, tail_r, tail_i,
                                    audio_tail, env0, dc0, agc_release, agc_target,
                                    agc_max_gain, agc_enabled, out_gain, in_gain,
                                    iq_balance, nb, nb_thresh_db, nb_tau,
                                    nb_avg0, nb_mask0)
    return launch_chain(xr, xi, inc, phase0, w_sb, w_pbt, tail_r, tail_i,
                        audio_tail, env0, agc_release, agc_target, agc_max_gain,
                        agc_enabled, out_gain, in_gain, iq_balance, nb,
                        nb_thresh_db, nb_tau, nb_avg0, nb_mask0, dc0)


def sam_args(xr, pll0, reseed, pll_bw_hz, sample_rate, chunk_t, wide=False) -> SamArgs:
    """The PLL carry, loop gains and re-seed schedule of a SAM chain call;
    ``reseed`` None is the JAX wrapper's schedule for one call of ``chunk_t``."""
    if reseed is None:
        reseed = sam_ops.reseed_schedule(xr.shape[-1], chunk_t, wide=wide)
    return SamArgs(pll0, sam_ops.pll_gains(pll_bw_hz, sample_rate), sam_ops.Reseed(*reseed))


def sweep_sam_chain_plain(xr, xi, inc, phase0, w_sb, w_pbt, tail_r, tail_i,
                          audio_tail, env0, dc0, pll0, agc_release, agc_target,
                          agc_max_gain, agc_enabled=True, out_gain=1.0, in_gain=1.0,
                          iq_balance=1.0, nb=False, nb_thresh_db=10.0, nb_tau=512.0,
                          nb_avg0=None, nb_mask0=None, reseed=None, pll_bw_hz=100.0,
                          sample_rate=sam_ops.SAMPLE_RATE):
    """Plain PyTorch version of ``sweep_sam_chain``."""
    check_stream(xr)
    return chain_plain(xr, xi, inc, phase0, w_sb, w_pbt, tail_r, tail_i,
                       audio_tail, env0, agc_release, agc_target, agc_max_gain,
                       agc_enabled, out_gain, in_gain, iq_balance, nb,
                       nb_thresh_db, nb_tau, nb_avg0, nb_mask0, dc0,
                       sam=sam_args(xr, pll0, reseed, pll_bw_hz, sample_rate, 1024))


def sweep_sam_chain(xr, xi, inc, phase0, w_sb, w_pbt, tail_r, tail_i, audio_tail,
                    env0, dc0, pll0, agc_release, agc_target, agc_max_gain,
                    agc_enabled=True, out_gain=1.0, in_gain=1.0, iq_balance=1.0,
                    nb=False, nb_thresh_db=10.0, nb_tau=512.0, nb_avg0=None,
                    nb_mask0=None, reseed=None, pll_bw_hz=100.0,
                    sample_rate=sam_ops.SAMPLE_RATE):
    """Whole SAM receive chain (the JAX ``sweep_lanes_chain(stage="sam")``);
    arguments as ``sweep_am_chain``, plus:

      pll0:    (2, C) PLL carry [phase row | freq row]
      reseed:  where the PLL's oscillator re-seeds (``sam.Reseed``): the
               JAX bank's kernel calls give ``sam.reseed_schedule(n,
               sam_chunk, max_kernel_seg)``; None is one JAX call of the
               wrapper's default chunk_t, ``sam.reseed_schedule(n, 1024)``

    Returns (audio_l, audio_r, audio_tail_next, env_next, dc_next, pll_next),
    and with nb=True also (nb_avg_next, nb_mask_next). CPU tensors run the
    plain version; CUDA tensors launch the kernel, or raise.
    """
    check_stream(xr)
    sam = sam_args(xr, pll0, reseed, pll_bw_hz, sample_rate, 1024)
    run = chain_plain if xr.device.type == "cpu" else launch_chain
    return run(xr, xi, inc, phase0, w_sb, w_pbt, tail_r, tail_i, audio_tail, env0,
               agc_release, agc_target, agc_max_gain, agc_enabled, out_gain, in_gain,
               iq_balance, nb, nb_thresh_db, nb_tau, nb_avg0, nb_mask0, dc0, sam=sam)
