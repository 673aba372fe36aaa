"""The SAM carrier PLL: K5 and the per-sample step K6 and K7 share.

Counterpart of ``radiodsp_sdr_rx_tpu/ops/pallas_sam.py``: ``atan2_poly``
(:41-68), ``sincos_wrapped`` (:83-96), ``pll_step_fast`` (:119-161) and
``pll_loop`` (:178-223) compute its functions, the one-divide polynomial
atan2, the shared-u^2 sin/cos polynomials on u = phase - pi, and the
split-phase step, whose oscillator for sample n+1 is the base sincos(phase +
fprev), known a step early, turned by the small angle (fnew - fprev) +
kp*err. They are the plain PyTorch versions of the device code in
``csrc/sam_pll.cuh`` and follow its algebra, which the kernels arrange for a
short dependent chain a step: the oscillator is never formed (the next
product is w * (cosg - j*sing) with w = z * conj(base), the small-angle
cos and sin expanded), the clip enters the angle as clamp(k*err, kp*err +
dlo, kp*err + dhi) with bounds known before err, the atan2's octant offset
and sign fold into its polynomial's last term, the polynomials run in
Estrin form, and the base's angle phase + fprev takes the phase before its
wrap (one wrap where JAX takes two). That is the JAX function up to rounding
(``tests/test_torch_sam.py`` holds it to JAX's step and, in float64, to its
recurrence). The oscillator re-seeds from the exact phase at the start of
every re-seed period, so the period is part of the function: 4,096 samples
for K5 (or the whole segment when shorter), what ``reseed_schedule`` gives
for K6 and K7.

``sam_pll_run`` is ``sam_pll_run_pallas`` (:258): the PLL over a (C, n)
segment of band-passed IQ, returning the in-phase product vr (before the DC
blocker) and the (C,) phase and frequency. CUDA tensors launch ``csrc/sam.cu``
(``sam_pll``) or raise; CPU tensors run ``sam_pll_run_plain``. The plain loop
is one vectorised step per sample, host-bound on the card. ``LAUNCHES`` counts
K5's launches. The JAX wrapper's 128-lane padding has no meaning here: any C
is taken (the banks keep their states padded to 128 lanes, as JAX does).
``probe`` runs the device divide and atan2 over arrays (``sam_probe``), for
the tests and ``chip_smoke.py``; it counts no launch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.ops.chain_common import check_launch, check_tensors
from radiodsp_sdr_rx_tpu_torch.utils import build
from radiodsp_sdr_rx_tpu_torch.utils.profiling import span

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
    """atan2 by octant reduction and the Cephes arctan polynomial, one divide:
    A + z + P(z^2)*z^3 with z = S*num/den, the offset A and the sign S from
    the octant, P in Estrin form."""
    ax, ay = x.abs(), y.abs()
    hi, lo = torch.maximum(ax, ay), torch.minimum(ax, ay)
    big, swap, negx, negy = lo > _TAN_PI_8 * hi, ay > ax, x < 0.0, y < 0.0
    zero = torch.zeros_like(x)
    off = torch.where(big, _PI_4, zero)
    off = torch.where(swap, _PI_2 - off, off)
    off = torch.where(negx, _PI - off, off)
    off = torch.where(negy, -off, off)
    num = torch.where(big, lo - hi, lo)
    den = torch.where(big, lo + hi, hi).clamp(min=_TINY)
    z = torch.where(swap ^ negx ^ negy, -num, num) / den
    z2 = z * z
    c4, c3, c2, c1 = _ATAN_C
    p = (z2 * z2) * (c4 * z2 - c3) + (c2 * z2 - c1)
    return (off + z) + p * (z2 * z)


def sincos_wrapped(phase: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of a phase in [0, 2*pi), on the centred u = phase - pi, the
    polynomials in u^2 in Estrin form."""
    u = phase - _PI
    v = u * u
    v2 = v * v
    v4 = v2 * v2
    s0, s1, s2, s3, s4, s5 = _SIN_C
    k0, k1, k2, k3, k4, k5, k6 = _COS_C
    sp = v4 * (s5 * v + s4) + (v2 * (s3 * v + s2) + (s1 * v + s0))
    cp = v4 * (v2 * k6 + (k5 * v + k4)) + (v2 * (k3 * v + k2) + (k1 * v + k0))
    return -cp, -(sp * u)


def _wrap(p: torch.Tensor) -> torch.Tensor:
    """Into [0, 2*pi) by two conditional selects (the increment is small)."""
    p = torch.where(p >= _TWO_PI, p - _TWO_PI, p)
    return torch.where(p < 0.0, p + _TWO_PI, p)


def pll_step_fast(zr, zi, cb, sb, corr, bnext, phase, fprev, gains: PllGains):
    """One split-phase step on the carried (phase, fprev), the base oscillator
    (cb, sb), the angle corr that turns it into this sample's oscillator and
    bnext, the next base's angle before its wrap (phase + fprev, phase taken
    before its own wrap). Returns (vr, cb', sb', corr', bnext', phase',
    freq')."""
    wr = zr * cb + zi * sb                  # w = z * conj(base)
    wi = zi * cb - zr * sb
    g2 = corr * corr
    vr = (wr + wi * corr) - g2 * (wr * 0.5 + (wi * _SIXTH) * corr)
    vi = (wi - wr * corr) - g2 * (wi * 0.5 - (wr * _SIXTH) * corr)
    err = atan2_poly(vi, vr)
    fnew = (fprev + gains.ki * err).clamp(-gains.max_freq, gains.max_freq)
    kpe = gains.kp * err
    k = float(np.float32(gains.ki) + np.float32(gains.kp))   # ki + kp in f32, as the kernels add
    corr = torch.minimum(torch.maximum(k * err, kpe + (-gains.max_freq - fprev)),
                         kpe + (gains.max_freq - fprev))
    praw = (phase + fnew) + kpe
    cb, sb = sincos_wrapped(_wrap(bnext))
    return vr, cb, sb, corr, praw + fnew, _wrap(praw), fnew


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
    the oscillator to sincos(phase) where ``reseed`` says. Returns (vr,
    phase', freq')."""
    n = zr.shape[-1]
    seeds = set(reseed.positions(n))
    vr = torch.empty_like(zr)
    cb = sb = corr = bnext = None
    for t in range(n):
        if t in seeds:
            (cb, sb), corr, bnext = sincos_wrapped(phase), torch.zeros_like(phase), phase + freq
        vr[:, t], cb, sb, corr, bnext, phase, freq = pll_step_fast(
            zr[:, t], zi[:, t], cb, sb, corr, bnext, phase, freq, gains)
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
    stream = torch.cuda.current_stream(zr.device).cuda_stream
    with span("rdsp.launch", kernel="sam_pll"):
        err = fn(*(t.data_ptr() for t in (zr, zi, phase0, freq0) + outs), c, n, chunk,
                 *pll_gains(bw_hz, sample_rate), zr.device.index or 0, stream)
    if err:
        raise RuntimeError(f"sam_pll launch failed: cudaError {err}")
    LAUNCHES += 1
    return outs


def probe(a: torch.Tensor, b: torch.Tensor):
    """The step's pieces over (n,) f32 tensors: (the explicit divide a / b,
    the compiler's IEEE a / b, atan2_poly(a, b)), y = a and x = b. CUDA
    tensors launch ``sam_probe`` (``csrc/sam.cu``), which LAUNCHES does not
    count, or raise; CPU tensors give the plain versions."""
    check_tensors({"a": (a, (a.numel(),), torch.float32),
                   "b": (b, (a.numel(),), torch.float32)}, a.device)
    if a.device.type == "cpu":
        return a / b, a / b, atan2_poly(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"the SAM probe runs on cuda or cpu, not {a.device}")
    check_launch("the SAM probe", (a, b))
    outs = tuple(torch.empty_like(a) for _ in range(3))
    fn = build.load_library("sam").sam_probe
    fn.argtypes = [_PTR] * 5 + [_I32, _I32, _PTR]
    fn.restype = ctypes.c_int
    err = fn(*(t.data_ptr() for t in (a, b) + outs), a.numel(), a.device.index or 0,
             torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"sam_probe launch failed: cudaError {err}")
    return outs


def probe_operands(seed: int, m: int = 1 << 20):
    """Operands of the PLL's divide for ``probe``, as float32 numpy arrays
    (num, den), den >= 1e-30 and |num| <= den (``csrc/sam_pll.cuh`` div_rn's
    range on the PLL's side): m pairs with den log-uniform in [1e-30, 2^24]
    and num = den * U(-1, 1); m/4 with |num| log-uniform in [2^-149, 2^-90]
    (subnormal ones included), where the unscaled residual would round; m/4
    with den log-uniform in [2^4, 2^24] whose quotient lies near a midpoint
    of the subnormal grid; then the edges: signed zeros, equal magnitudes,
    the big test's boundary num = tan(pi/8) * den, num one ulp under den,
    den = 1e-30, the smallest subnormal and normal numerators."""
    rng = np.random.default_rng(seed)

    def log_uniform(lo, hi, k):
        return np.exp(rng.uniform(np.log(lo), np.log(hi), k)).astype(np.float32)

    def signs(k):
        return rng.choice(np.float32([-1.0, 1.0]), k)

    den = log_uniform(1e-30, 2.0 ** 24, m)
    num = np.clip((den * rng.uniform(-1.0, 1.0, m)).astype(np.float32), -den, den)
    k = m // 4
    tden = log_uniform(1e-30, 2.0 ** 24, k)
    tnum = np.minimum(log_uniform(2.0 ** -149, 2.0 ** -90, k), tden) * signs(k)
    sden = log_uniform(2.0 ** 4, 2.0 ** 24, k)
    mid = (rng.integers(0, 1 << 23, k) + 0.5) * 2.0 ** -149
    snum = np.minimum((sden * mid).astype(np.float32), sden) * signs(k)
    t = np.float32(_TAN_PI_8)
    edges = [(n, d) for d in np.float32([1e-30, 3e-30, 1e-20, 1e-3, 0.5, 1.0, 3.0, 1e6, 2.0 ** 24])
             for n in (0.0, -0.0, d, -d, t * d, -t * d, np.nextafter(d, np.float32(0)),
                       np.float32(1e-30), np.float32(-4e-31), np.float32(2.0 ** -149),
                       np.float32(-2.0 ** -149), np.float32(2.0 ** -126))
             if abs(n) <= d]
    en, ed = (np.array(a, np.float32) for a in zip(*edges))
    return np.concatenate([num, tnum, snum, en]), np.concatenate([den, tden, sden, ed])
