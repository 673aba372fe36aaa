"""The SAM carrier PLL: K5 and the per-sample step K6 and K7 share.

Counterpart of ``radiodsp_sdr_rx_tpu/ops/pallas_sam.py``. ``atan2_poly``
(:41-68), ``sincos_wrapped`` (:83-96), ``pll_step_fast`` (:119-161) and
``pll_loop`` (:178-223) are the plain PyTorch versions of the device code in
``csrc/sam_pll.cuh``: the one-divide polynomial atan2, the shared-u^2 sin/cos
polynomials on u = phase - pi, and the split-phase step that carries the
reference oscillator (cr, ci) and builds the next one as sincos(phase +
fprev) turned by the small angle (fnew - fprev) + kp*err. The oscillator
re-seeds from the exact phase at the start of every re-seed period, so the
period is part of the function: 4,096 samples for K5 (or the whole segment
when shorter), what ``reseed_schedule`` gives for K6 and K7.

``sam_pll_run`` is ``sam_pll_run_pallas`` (:258): the PLL over a (C, n)
segment of band-passed IQ, returning the in-phase product vr (before the DC
blocker) and the (C,) phase and frequency. CUDA tensors launch ``csrc/sam.cu``
(``sam_pll``) or raise; CPU tensors run ``sam_pll_run_plain``. The plain loop
is one vectorised step per sample, host-bound on the card. ``LAUNCHES`` counts
K5's launches. The JAX wrapper's 128-lane padding has no meaning here: any C
is taken (the banks keep their states padded to 128 lanes, as JAX does).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.ops.chain_common import check_launch, check_tensors
from radiodsp_sdr_rx_tpu_torch.utils import build

LAUNCHES = 0   # sam_pll
SAMPLE_RATE = 44117.64706

_PI = float(np.float32(np.pi))
_PI_2 = float(np.float32(np.pi / 2.0))
_PI_4 = float(np.float32(np.pi / 4.0))
_TWO_PI = float(np.float32(2.0 * np.pi))
_SIXTH = float(np.float32(1.0 / 6.0))
_TAN_PI_8 = float(np.float32(0.41421356))
_TINY = float(np.float32(1e-30))
_ATAN_C = tuple(float(np.float32(c)) for c in (
    8.05374449538e-2, 1.38776856032e-1, 1.99777106478e-1, 3.33329491539e-1))
_SIN_C = tuple(float(np.float32(c)) for c in (
    9.999997070358e-1, -1.666657721752e-1, 8.33255813248e-3,
    -1.981257592934e-4, 2.704051697171e-6, -2.053426506405e-8))
_COS_C = tuple(float(np.float32(c)) for c in (
    9.999999922852e-1, -4.999999177215e-1, 4.166652436402e-2,
    -1.388797041112e-3, 2.477342417935e-5, -2.711337293093e-7,
    1.73691328957e-9))


class PllGains(NamedTuple):
    """The loop constants, computed in float64 and cast to float32, as
    ``sam_pll_run_pallas`` computes them (:281-285)."""

    kp: float
    ki: float
    max_freq: float


def pll_gains(bw_hz: float = 100.0, sample_rate: float = SAMPLE_RATE) -> PllGains:
    wn = 2.0 * np.pi * bw_hz / sample_rate
    return PllGains(kp=float(np.float32(2.0 * 0.70710678 * wn)),
                    ki=float(np.float32(wn * wn)),
                    max_freq=float(np.float32(2.0 * np.pi * 2000.0 / sample_rate)))


def atan2_poly(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2 by octant reduction and the Cephes arctan polynomial, one divide."""
    ax, ay = x.abs(), y.abs()
    hi, lo = torch.maximum(ax, ay), torch.minimum(ax, ay)
    big = lo > _TAN_PI_8 * hi
    z1 = torch.where(big, lo - hi, lo) / torch.where(big, lo + hi, hi).clamp(min=_TINY)
    z2 = z1 * z1
    c4, c3, c2, c1 = _ATAN_C
    p = ((((c4 * z2 - c3) * z2 + c2) * z2 - c1) * z2) * z1 + z1
    t = torch.where(big, _PI_4 + p, p)
    t = torch.where(ay > ax, _PI_2 - t, t)
    t = torch.where(x < 0.0, _PI - t, t)
    return torch.where(y < 0.0, -t, t)


def sincos_wrapped(phase: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of a phase in [0, 2*pi), on the centred u = phase - pi."""
    u = phase - _PI
    u2 = u * u
    s = torch.full_like(u, _SIN_C[-1])
    for c in _SIN_C[-2::-1]:
        s = s * u2 + c
    co = torch.full_like(u, _COS_C[-1])
    for c in _COS_C[-2::-1]:
        co = co * u2 + c
    return -co, -(s * u)


def _wrap(p: torch.Tensor) -> torch.Tensor:
    """Into [0, 2*pi) by two conditional selects (the increment is small)."""
    p = torch.where(p >= _TWO_PI, p - _TWO_PI, p)
    return torch.where(p < 0.0, p + _TWO_PI, p)


def pll_step_fast(zr, zi, cr, ci, phase, fprev, gains: PllGains):
    """One split-phase step. Returns (vr, cr', ci', phase', freq')."""
    vr = zr * cr + zi * ci
    vi = zi * cr - zr * ci
    err = atan2_poly(vi, vr)
    fnew = (fprev + gains.ki * err).clamp(-gains.max_freq, gains.max_freq)
    corr = (fnew - fprev) + gains.kp * err
    p = _wrap(phase + fnew + gains.kp * err)
    cb, sb = sincos_wrapped(_wrap(phase + fprev))
    g2 = corr * corr
    sing = corr * (1.0 - g2 * _SIXTH)
    cosg = 1.0 - g2 * 0.5
    return vr, cb * cosg - sb * sing, sb * cosg + cb * sing, p, fnew


class Reseed(NamedTuple):
    """Where the oscillator re-seeds in one kernel call: every ``period``
    samples before ``split``, every ``period2`` samples from ``split`` on
    (the JAX bank's whole ``max_kernel_seg`` sub-segments, then its remainder
    call). ``csrc/sam_pll.cuh`` has the same struct."""

    period: int
    split: int
    period2: int

    def positions(self, n: int) -> list[int]:
        return list(range(0, min(self.split, n), self.period)) + \
            list(range(self.split, n, self.period2))


def pll_loop(zr, zi, phase, freq, gains: PllGains, reseed: Reseed):
    """The PLL over (C, n) band-passed IQ, one step per sample, re-seeding
    (cr, ci) = sincos(phase) where ``reseed`` says. Returns (vr, phase',
    freq')."""
    n = zr.shape[-1]
    seeds = set(reseed.positions(n))
    vr = torch.empty_like(zr)
    cr = ci = None
    for t in range(n):
        if t in seeds:
            cr, ci = sincos_wrapped(phase)
        vr[:, t], cr, ci, phase, freq = pll_step_fast(zr[:, t], zi[:, t], cr, ci, phase,
                                                      freq, gains)
    return vr, phase, freq


def even_chunks(n: int, chunk_t: int) -> int:
    """Largest chunk <= chunk_t, halving from it, that divides n, as
    ``pallas_sweep._even_chunks`` (:44) chooses the TPU kernels' time chunk."""
    chunk_t = min(chunk_t, n)
    while chunk_t >= 128 and n % chunk_t:
        chunk_t //= 2
    if chunk_t < 128:
        raise ValueError(f"n={n} must be a multiple of 128")
    return chunk_t


def lanes_chunk(n: int, chunk_t: int) -> int:
    """The PLL chunk of one ``sweep_lanes_chain`` call (pallas_chain_lanes.py:
    835-842): ``even_chunks``, halved once when that leaves an odd count."""
    chunk_t = even_chunks(n, chunk_t)
    if (n // chunk_t) % 2 and n > chunk_t and chunk_t % 256 == 0:
        chunk_t //= 2
    return chunk_t


def reseed_schedule(n: int, chunk_t: int, kernel_seg: int | None = None,
                    wide: bool = False) -> Reseed:
    """The re-seed schedule of a folded JAX ``FusedSAMBank`` segment of n
    samples: whole ``kernel_seg`` sub-segments (``max_kernel_seg``,
    fused.py:801-828), then one remainder call, each kernel call with the
    chunk its own length gives; ``wide`` is K7's rule (``even_chunks`` of
    the chunk, no halving), else K6's (``lanes_chunk``)."""
    chunk_of = (lambda m: even_chunks(m, chunk_t)) if wide else \
        (lambda m: lanes_chunk(m, chunk_t))
    if kernel_seg is None or n <= kernel_seg:
        p = chunk_of(n)
        return Reseed(p, n, p)
    split = (n // kernel_seg) * kernel_seg
    p = chunk_of(kernel_seg)
    return Reseed(p, split, chunk_of(n - split) if split < n else p)


def _check_args(zr, zi, phase0, freq0):
    if zr.dim() != 2 or zr.shape[1] == 0:
        raise ValueError(f"zr must be (C, n) with n > 0, got {tuple(zr.shape)}")
    c, n = zr.shape
    check_tensors({"zi": (zi, (c, n), torch.float32),
                   "phase0": (phase0, (c,), torch.float32),
                   "freq0": (freq0, (c,), torch.float32),
                   "zr": (zr, (c, n), torch.float32)}, zr.device)


def _chunk(n: int, chunk: int) -> int:
    chunk = min(chunk, n)
    if chunk <= 0 or n % chunk:
        raise ValueError("n must be a multiple of chunk")
    return chunk


def sam_pll_run_plain(zr, zi, phase0, freq0, bw_hz=100.0, sample_rate=SAMPLE_RATE,
                      chunk=4096):
    """Plain PyTorch version of ``sam_pll_run``."""
    _check_args(zr, zi, phase0, freq0)
    chunk = _chunk(zr.shape[1], chunk)
    return pll_loop(zr, zi, phase0, freq0, pll_gains(bw_hz, sample_rate),
                    Reseed(chunk, zr.shape[1], chunk))


_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def sam_pll_run(zr, zi, phase0, freq0, bw_hz=100.0, sample_rate=SAMPLE_RATE, chunk=4096):
    """The PLL over a segment:

      zr, zi:        (C, n) f32 band-passed IQ
      phase0, freq0: (C,) f32 PLL carries (phase in [0, 2*pi))
      chunk:         the re-seed period, min(chunk, n); n must be a multiple

    Returns (vr (C, n), phase', freq'); run ``ops/iir.dc_blocker`` on vr for
    ``planar.demod_sam_planar``'s audio. CPU tensors run the plain version;
    CUDA tensors launch K5, or raise.
    """
    global LAUNCHES
    if zr.device.type == "cpu":
        return sam_pll_run_plain(zr, zi, phase0, freq0, bw_hz, sample_rate, chunk)
    if zr.device.type != "cuda":
        raise ValueError(f"the SAM PLL runs on cuda or cpu, not {zr.device}")
    _check_args(zr, zi, phase0, freq0)
    c, n = zr.shape
    chunk = _chunk(n, chunk)
    check_launch("the SAM PLL", (zr, zi, phase0, freq0))
    outs = (torch.empty_like(zr), torch.empty_like(phase0), torch.empty_like(freq0))
    fn = build.load_library("sam").sam_pll
    fn.argtypes = [_PTR] * 7 + [_I32] * 3 + [_F32] * 3 + [_I32, _PTR]
    fn.restype = ctypes.c_int
    err = fn(*(t.data_ptr() for t in (zr, zi, phase0, freq0) + outs), c, n, chunk,
             *pll_gains(bw_hz, sample_rate), zr.device.index or 0,
             torch.cuda.current_stream(zr.device).cuda_stream)
    if err:
        raise RuntimeError(f"sam_pll launch failed: cudaError {err}")
    LAUNCHES += 1
    return outs
