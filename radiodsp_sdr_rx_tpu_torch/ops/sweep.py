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
kernels' launches. ``launch_chain`` launches every source of the chain
(these seven; ``ops/lanes.py``'s NR stages, whose plain versions
``chain_plain`` also computes from ``LmsArgs`` and ``SpecArgs``; K7 of
``ops/sam_wide.py``) through one C entry that takes a ``ChainArgs``
(``csrc/chain_args.cuh``). The chain wrappers do not take the JAX wrappers'
TPU tiling knobs (``block_c``, ``chunk_t``, ``interpret``): they have no
meaning here. The spectral stage takes the dense DFT operators
(``SpecArgs.w_fwd``, ``w_inv``), which the plain version multiplies by; the
kernels run a 256-point FFT instead, the same function only for those
operators, so ``launch_chain`` admits no others (``check_spectral_ops``).

``sweep_mix_filter_demod`` (:147, kernel ``_sweep_kernel`` :59) is the
front of the chain alone from a stream start: mix, band-pass and SSB demod,
times ``out_gain``, nothing carried. It launches ``sweep_mix_demod`` of
``csrc/staged.cu`` (K2a's kernel without the tail) for CUDA tensors and
runs ``sweep_mix_filter_demod_plain`` for CPU ones; ``LAUNCHES_SWEEP_MIX``
counts its launches. It keeps the JAX signature; ``block_c`` and
``chunk_t`` are validated as JAX does and change nothing else.
"""

from __future__ import annotations

import ctypes
import math
import weakref
from typing import NamedTuple

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.ops import lms_bank, staged
from radiodsp_sdr_rx_tpu_torch.ops import sam as sam_ops
from radiodsp_sdr_rx_tpu_torch.ops.chain_common import (
    BLOCK,
    check_launch,
    check_stream,
    check_tensors,
    demod_frames,
    iir_rows,
    matmul_fp32,
    mix,
    pbt_frames,
)
from radiodsp_sdr_rx_tpu_torch.ops.iir import DC_POLE
from radiodsp_sdr_rx_tpu_torch.ops.lms import LMS_DELAY, LMS_TAPS
from radiodsp_sdr_rx_tpu_torch.ops.spectral_sub import (
    UNDER_FLOOR_GAIN,
    VAD_END_BIN,
    VAD_START_BIN,
    fft_twiddles,
    floor_track,
    spectral_matmul_ops,
)
from radiodsp_sdr_rx_tpu_torch.utils import build

LAUNCHES = 0        # sweep_chain_ssb
LAUNCHES_NB = 0     # sweep_chain_ssb_nb
LAUNCHES_AM = 0     # sweep_chain_am
LAUNCHES_AM_NB = 0  # sweep_chain_am_nb
LAUNCHES_MONO = 0   # sweep_chain_ssb_mono
LAUNCHES_SAM = 0    # sweep_chain_sam
LAUNCHES_SAM_NB = 0  # sweep_chain_sam_nb
LAUNCHES_SWEEP_MIX = 0  # sweep_mix_demod


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


class LmsArgs(NamedTuple):
    """An LMS stage's carries and constants (``ops/lms_bank.lms_nr_run_bank``)."""

    weights: torch.Tensor   # (C, 96)
    window: torch.Tensor    # (C, 96)
    delay: torch.Tensor     # (C, 128)
    first: torch.Tensor     # () bool: the reference's first-block quirk
    mu: float
    mode: str               # "denoise" (after PBT, out y) or "notch" (before the AGC, out e)


class SpecArgs(NamedTuple):
    """The spectral stage's operators, carries and level."""

    w_fwd: torch.Tensor     # (512, 512) spectral_sub.spectral_matmul_ops forward DFT
    w_inv: torch.Tensor     # (512, 256) its right-half inverse
    nfloor0: torch.Tensor   # (C,) noise-floor carry (zeros at stream start)
    tail_l: torch.Tensor    # (C, 128) the previous post-PBT block of l
    tail_r: torch.Tensor    # (C, 128) ... and of r
    nr_level: float         # subtraction strength (20/30/40/50 for SPEC1-4)


def nr_gain(nr_level) -> float:
    """The per-frame floor multiplier level * 1.5 / 150 as an f32 value: the
    mean over the VAD band divides its 151-bin sum by 150, the reference's
    own off-by-one (RDSP_convolutional_spec.h:200)."""
    return float(np.float32(float(nr_level) * 1.5 / float(VAD_END_BIN - VAD_START_BIN)))


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


def spectral_plain(l, r, spec: SpecArgs):
    """The spectral stage on the post-PBT l, r (C, n), the floor a doubling
    scan across rows from its carry. Returns (l', r', nfloor', tail_l',
    tail_r')."""
    c, n = l.shape
    sr, si, mag, nfloor = spectral_floor(l, r, spec.w_fwd, spec.nfloor0, spec.tail_l,
                                         spec.tail_r, spec.nr_level)
    nf = nfloor.clamp(min=0.0)[..., None]
    scale = torch.where(mag <= nf, UNDER_FLOOR_GAIN, 1.0 - nf / mag.clamp(min=1e-20))
    del mag
    y = matmul_fp32(torch.cat([sr * scale, si * scale], dim=-1), spec.w_inv)
    del sr, si, scale
    return (y[..., :BLOCK].reshape(c, n), y[..., BLOCK:].reshape(c, n),
            nfloor[:, -1].contiguous(), l[:, -BLOCK:].contiguous(), r[:, -BLOCK:].contiguous())


def _check_nr(xr, lms: LmsArgs | None, spec: SpecArgs | None):
    if lms is not None and spec is not None:
        raise ValueError("one NR stage: an LmsArgs (denoise, notch) or a SpecArgs (spectral)")
    c = xr.shape[0]
    f32 = torch.float32
    if lms is not None:
        if lms.mode not in lms_bank.MODES:
            raise ValueError(f"LMS mode must be one of {lms_bank.MODES}, got {lms.mode!r}")
        check_tensors({"lms weights": (lms.weights, (c, LMS_TAPS), f32),
                       "lms window": (lms.window, (c, LMS_TAPS), f32),
                       "lms delay": (lms.delay, (c, LMS_DELAY), f32),
                       "lms first": (lms.first, (), torch.bool)}, xr.device)
    if spec is not None:
        check_tensors({"w_spec_fwd": (spec.w_fwd, (512, 512), f32),
                       "w_spec_inv": (spec.w_inv, (512, 256), f32),
                       "nfloor0": (spec.nfloor0, (c,), f32),
                       "spec_tail_l": (spec.tail_l, (c, BLOCK), f32),
                       "spec_tail_r": (spec.tail_r, (c, BLOCK), f32)}, xr.device)


def chain_plain(xr, xi, inc, phase0, w, w_pbt, tail_r, tail_i, audio_tail,
                env0, agc_release, agc_target, agc_max_gain, agc_enabled,
                out_gain, in_gain, iq_balance, nb, nb_thresh_db, nb_tau,
                nb_avg0, nb_mask0, dc0=None, emit_r=True, sam: SamArgs | None = None,
                lms: LmsArgs | None = None, spec: SpecArgs | None = None):
    """The plain chain, SSB, (``dc0`` given) AM or (``sam`` given too) SAM,
    vectorised over the whole segment but for the SAM PLL and the LMS (one
    step per sample, ``sam.pll_loop`` and ``lms_bank.lms_nr_run_bank_plain``):
    the AGC, the blanker's average and the DC blocker run as the TPU kernel's
    doubling scans (within a 128-sample row, then across rows) plus the row
    carry. Every product is full fp32 (``chain_common.matmul_fp32``), as the
    kernels compute them; without ``emit_r`` R is computed and dropped, so L
    is the emit_r=True L. With ``lms`` in notch mode the LMS error replaces
    the audio before the AGC; in denoise mode the LMS prediction of L, times
    1.1, is L, and R is not returned. With ``spec`` the spectral stage runs
    on [L|R] before the output gain. Returns (L, R, audio_tail', env'), then
    dc' (AM, SAM), pll' (SAM), the LMS's weights', window', delay', the
    spectral stage's nfloor', tail_l', tail_r', and the blanker's nb_avg',
    nb_mask', each where its stage ran."""
    check_chain_args(xr, xi, inc, phase0, w, w_pbt, tail_r, tail_i, audio_tail,
                env0, agc_release, nb, nb_tau, nb_avg0, nb_mask0, dc0, emit_r,
                None if sam is None else sam.pll0)
    _check_nr(xr, lms, spec)
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
    nr_out = ()
    if lms is not None and lms.mode == "notch":
        e, *nr_out = lms_bank.lms_nr_run_bank_plain(audio.reshape(c, n), *lms)
        audio = e.view(audio.shape)

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
    l, r = lr[..., :BLOCK].reshape(c, n), lr[..., BLOCK:].reshape(c, n)
    del lr
    if lms is not None and lms.mode == "denoise":
        l, *nr_out = lms_bank.lms_nr_run_bank_plain(l, *lms)
        l, emit_r = l * float(np.float32(1.1)), False   # makeup (RDSP_convolutional.h:334)
    elif spec is not None:
        l, r, *nr_out = spectral_plain(l, r, spec)
    og = float(np.float32(out_gain))
    out = (l * og, r * og if emit_r else None, audio[:, -1].contiguous(),
           envl[:, -1, -1].contiguous())
    if dc0 is not None:
        out += (dc,)
    if sam is not None:
        out += (pll,)
    out += tuple(nr_out)
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


_CONSTS: dict = {}         # device -> its copies of the spectral stage's constants
_SPEC_CHECKED: dict = {}   # (data_ptr, _version) -> weakref of an operator found equal


def _device_consts(device) -> dict:
    """The dense DFT operators and the FFT twiddle table on ``device``, made
    once."""
    key = str(device)
    if key not in _CONSTS:
        w_fwd, w_inv = spectral_matmul_ops(256)
        _CONSTS[key] = {k: torch.as_tensor(v, device=device) for k, v in (
            ("w_spec_fwd", w_fwd), ("w_spec_inv", w_inv), ("fft_tw", fft_twiddles()))}
    return _CONSTS[key]


def check_spectral_ops(w_fwd: torch.Tensor, w_inv: torch.Tensor) -> None:
    """Raise ValueError unless ``w_fwd`` and ``w_inv`` equal
    ``spectral_matmul_ops(256)``'s operators: the kernels compute the
    spectral stage as a 256-point FFT, which is the function of these
    operands only because they are the DFT. Each tensor is compared once
    while it stays unchanged (keyed by its data pointer and version)."""
    for name, w in (("w_spec_fwd", w_fwd), ("w_spec_inv", w_inv)):
        key = (w.data_ptr(), w._version)
        seen = _SPEC_CHECKED.get(key)
        if seen is not None and seen() is w:
            continue
        want = _device_consts(w.device)[name]
        if not torch.equal(w, want):
            raise ValueError(f"{name} is not spectral_sub.spectral_matmul_ops(256)'s operator: "
                             "the spectral kernels compute the stage by FFT and take the DFT "
                             "operators alone")
        _SPEC_CHECKED[key] = weakref.ref(w)


class _ChainArgs(ctypes.Structure):
    """``ChainArgs`` of csrc/chain_args.cuh, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "xr", "xi", "inc", "phase0", "w_band", "w_pbt", "tail_r", "tail_i", "atail_in",
        "env0", "out_l", "out_r", "atail_out", "env_out", "nb_avg0", "nb_mask0",
        "nb_avg_out", "nb_mask_out", "dc0", "dc_out", "pll0", "pll_out", "lms_w0",
        "lms_win0", "lms_delay0", "lms_first", "lms_w_out", "lms_win_out", "lms_delay_out",
        "fft_tw", "nfl0", "stl0", "str0", "nfl_out", "stl_out", "str_out")] + [
        ("release", ctypes.c_double), ("nb_a", ctypes.c_double), ("n", ctypes.c_int),
        ("agc_enabled", ctypes.c_int)] + [(name, ctypes.c_float) for name in (
            "target", "max_gain", "out_gain", "g_i", "g_q", "nb_thresh", "mu", "nr_gain",
            "kp", "ki", "max_freq")] + [(name, ctypes.c_int) for name in (
                "period", "split", "period2")]


# the sources of csrc/sweep_chain.cuh's instantiations, by NR stage
LIBRARIES = {None: "sweep_chain", "denoise": "sweep_denoise", "notch": "sweep_notch",
             "spectral": "sweep_spec"}
_DEMODS = ("ssb", "am", "sam")
_COUNTERS = {"sweep_chain_ssb": "LAUNCHES", "sweep_chain_ssb_nb": "LAUNCHES_NB",
             "sweep_chain_am": "LAUNCHES_AM", "sweep_chain_am_nb": "LAUNCHES_AM_NB",
             "sweep_chain_ssb_mono": "LAUNCHES_MONO", "sweep_chain_sam": "LAUNCHES_SAM",
             "sweep_chain_sam_nb": "LAUNCHES_SAM_NB"}


def launch_chain(xr, xi, inc, phase0, w, w_pbt, tail_r, tail_i, audio_tail,
                 env0, agc_release, agc_target, agc_max_gain, agc_enabled,
                 out_gain, in_gain, iq_balance, nb, nb_thresh_db, nb_tau,
                 nb_avg0, nb_mask0, dc0=None, emit_r=True, sam: SamArgs | None = None,
                 lms: LmsArgs | None = None, spec: SpecArgs | None = None,
                 groups: int | None = None):
    """Check, allocate the outputs and launch one instantiation of
    ``csrc/sweep_chain.cuh``'s kernel (the source by NR stage, ``LIBRARIES``)
    or, with ``groups``, the SAM chain of ``csrc/sam_wide.cu``; every source
    takes a ``ChainArgs``. Counts the launches of ``sweep_chain.cu``'s seven
    kernels; the other callers count their own. Returns the outputs in the
    order of ``chain_plain``'s return."""
    if xr.device.type != "cuda":
        raise ValueError(f"the sweep chain runs on cuda or cpu, not {xr.device}")
    check_chain_args(xr, xi, inc, phase0, w, w_pbt, tail_r, tail_i, audio_tail, env0,
                     agc_release, nb, nb_tau, nb_avg0, nb_mask0, dc0, emit_r,
                     None if sam is None else sam.pll0)
    _check_nr(xr, lms, spec)
    emit_r = emit_r and (lms is None or lms.mode != "denoise")
    ins = dict(xr=xr, xi=xi, inc=inc, phase0=phase0, w_band=w, w_pbt=w_pbt, tail_r=tail_r,
               tail_i=tail_i, atail_in=audio_tail, env0=env0)
    if nb:
        ins.update(nb_avg0=nb_avg0, nb_mask0=nb_mask0)
    if dc0 is not None:
        ins.update(dc0=dc0)
    if sam is not None:
        ins.update(pll0=sam.pll0)
    if lms is not None:
        ins.update(lms_w0=lms.weights, lms_win0=lms.window, lms_delay0=lms.delay)
    if spec is not None:
        check_spectral_ops(spec.w_fwd, spec.w_inv)
        ins.update(fft_tw=_device_consts(xr.device)["fft_tw"], nfl0=spec.nfloor0,
                   stl0=spec.tail_l, str0=spec.tail_r)
    check_launch("the sweep chain", ins.values())
    if lms is not None:
        ins.update(lms_first=lms.first.to(torch.uint8).reshape(1))
    outs = dict(out_l=torch.empty_like(xr), out_r=torch.empty_like(xr) if emit_r else None,
                atail_out=torch.empty_like(audio_tail), env_out=torch.empty_like(env0))
    if dc0 is not None:
        outs.update(dc_out=torch.empty_like(dc0))
    if sam is not None:
        outs.update(pll_out=torch.empty_like(sam.pll0))
    if lms is not None:
        outs.update(lms_w_out=torch.empty_like(lms.weights),
                    lms_win_out=torch.empty_like(lms.window),
                    lms_delay_out=torch.empty_like(lms.delay))
    if spec is not None:
        outs.update(nfl_out=torch.empty_like(spec.nfloor0), stl_out=torch.empty_like(spec.tail_l),
                    str_out=torch.empty_like(spec.tail_r))
    if nb:
        outs.update(nb_avg_out=torch.empty_like(nb_avg0), nb_mask_out=torch.empty_like(nb_mask0))
    args = _ChainArgs(**{k: t.data_ptr() for k, t in {**ins, **outs}.items() if t is not None})
    c, n = xr.shape
    args.n, args.release, args.agc_enabled = n, float(agc_release), int(bool(agc_enabled))
    args.target, args.max_gain = float(np.float32(agc_target)), float(np.float32(agc_max_gain))
    args.out_gain = float(np.float32(out_gain))
    args.g_i = float(np.float32(in_gain))
    args.g_q = float(np.float32(in_gain * iq_balance))
    if nb:
        thresh, args.nb_a = nb_constants(nb_thresh_db, nb_tau)
        args.nb_thresh = float(np.float32(thresh))
    if sam is not None:
        args.kp, args.ki, args.max_freq = sam.gains
        args.period, args.split, args.period2 = sam.reseed
    if lms is not None:
        args.mu = float(np.float32(lms.mu))
    if spec is not None:
        args.nr_gain = nr_gain(spec.nr_level)
    nr = "spectral" if spec is not None else None if lms is None else lms.mode
    demod = "sam" if sam else "am" if dc0 is not None else "ssb"
    lib = "sam_wide" if groups is not None else LIBRARIES[nr]
    fn = build.load_library(lib).launch_chain
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(ctypes.addressof(args), _DEMODS.index(demod) if groups is None else groups,
             int(bool(nb)), c, xr.device.index or 0,
             torch.cuda.current_stream(xr.device).cuda_stream)
    if err:
        raise RuntimeError(f"{lib} launch failed: cudaError {err}")
    name = f"sweep_chain_{demod}{'_nb' if nb else ''}{'' if emit_r else '_mono'}"
    if lib == "sweep_chain":
        globals()[_COUNTERS[name]] += 1
    tail = [outs.get(k) for k in ("dc_out", "pll_out", "lms_w_out", "lms_win_out",
                                  "lms_delay_out", "nfl_out", "stl_out", "str_out",
                                  "nb_avg_out", "nb_mask_out")]
    return (outs["out_l"], outs["out_r"], outs["atail_out"], outs["env_out"],
            *(t for t in tail if t is not None))


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


# ---------------- mix + band-pass + SSB demod from a stream start (K8) ----------------

def _check_sweep_mix(xr, xi, inc, phase0, w, block_c, chunk_t):
    check_stream(xr)
    c, n = xr.shape
    sam_ops.even_chunks(n, chunk_t)   # the JAX wrapper's chunk check
    if block_c <= 0 or c % block_c:
        raise ValueError(f"the channel count {c} must be a positive multiple of "
                         f"block_c={block_c} (the JAX grid is C // block_c)")
    check_tensors({"xi": (xi, (c, n), torch.float32),
                   "inc": (inc, (c,), torch.int64),
                   "phase0": (phase0, (c,), torch.int64),
                   "w": (w, (4 * BLOCK, BLOCK), torch.float32),
                   "xr": (xr, (c, n), torch.float32)}, xr.device)


def sweep_mix_filter_demod_plain(xr, xi, inc, phase0, w, out_gain=1.0, block_c=8,
                                 chunk_t=4096):
    """Plain PyTorch version of ``sweep_mix_filter_demod``."""
    _check_sweep_mix(xr, xi, inc, phase0, w, block_c, chunk_t)
    c, n = xr.shape
    br, bi = mix(xr, xi, phase0, inc, torch.arange(n, dtype=torch.int64, device=xr.device))
    zero = torch.zeros(c, BLOCK, device=xr.device)
    return demod_frames(br, bi, zero, zero, w).reshape(c, n) * float(np.float32(out_gain))


def sweep_mix_filter_demod(xr, xi, inc, phase0, w, out_gain=1.0, block_c=8, chunk_t=4096):
    """DDS NCO mix + sideband filter + SSB demod of a stream from its start.

      xr, xi:      (C, n) f32 planar IQ, n a multiple of 128
      inc, phase0: (C,) int64 DDS words in [0, 2^32); sample j mixes at
                   phase0 + j*inc (mod 2^32)
      w:           (512, 128) ssb_demod_operator
      out_gain:    f32 factor on the audio
      block_c, chunk_t: the TPU kernel's tiling, checked as the JAX wrapper
                   checks them (C a multiple of block_c; chunk_t as
                   ``_even_chunks``); the result does not depend on them

    The framing tails start at zero. Returns the audio (C, n) f32. CPU
    tensors run the plain version; CUDA tensors launch the kernel, or raise.
    """
    global LAUNCHES_SWEEP_MIX
    if xr.device.type == "cpu":
        return sweep_mix_filter_demod_plain(xr, xi, inc, phase0, w, out_gain, block_c, chunk_t)
    if xr.device.type != "cuda":
        raise ValueError(f"sweep_mix_filter_demod runs on cuda or cpu, not {xr.device}")
    _check_sweep_mix(xr, xi, inc, phase0, w, block_c, chunk_t)
    check_launch("sweep_mix_filter_demod", (xr, xi, inc, phase0, w))
    c, n = xr.shape
    audio = torch.empty_like(xr)
    staged.launch("sweep_mix_demod", xr.device,
                  *(t.data_ptr() for t in (xr, xi, inc, phase0, w, audio)),
                  c, n, xr.device.index or 0, float(np.float32(out_gain)))
    LAUNCHES_SWEEP_MIX += 1
    return audio
