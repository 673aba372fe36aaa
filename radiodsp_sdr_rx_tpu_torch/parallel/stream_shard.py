"""Time- and channel-sharded chains (``radiodsp_sdr_rx_tpu/parallel/stream_shard.py``).

The receiver's only long-range state is the overlap-save carry (each frame
reuses the previous 128 samples) and a few first-order recurrences (the AGC
envelope, the DC blocker, the blanker's average, the spectral floor). So a
stream shards over time as ring/context parallelism does:

  - the 128-sample tail becomes a halo from the left neighbour
    (``_shift_from_left``, or the K9 kernel with ``halo="kernel"``);
  - each recurrence is solved per shard from a neutral start, the shards'
    boundary summaries are all-gathered, and every shard composes its true
    start (affine maps for the IIRs, max-plus for the AGC envelope);
  - the adaptive stages (LMS, the SAM PLL) need a channel's whole stream, so
    ``make_full_sharded_chain`` trades the time split for a finer channel
    split with one all_to_all, runs them, and trades back.

Each function runs over the lines of shards of a ``parallel/mesh.Mesh``
that this process holds, through the collectives of
``parallel/collectives.py``. The building blocks
(``sharded_overlap_save``, ``sharded_first_order_iir``,
``sharded_agc_envelope``) are the JAX functions called inside ``shard_map``:
they take the list of local shards and the axis. The chain builders return
functions of global tensors, as the JAX ones return jitted ``shard_map``s,
and split them over the mesh inside. The sharded chains equal the unsharded
chain to f32 rounding, not bit for bit: the seam fix-ups reassociate sums.

As in JAX, only ``sharded_overlap_save`` and ``make_time_sharded_ssb_chain``
take ``halo``; the AM DC-blocker seam, the spectral seams and the panadapter
always take the ppermute halo.
"""

from __future__ import annotations

import copy
import math
from typing import NamedTuple

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.ops import agc as agc_ops
from radiodsp_sdr_rx_tpu_torch.ops import analyzers, demod, fastconv, iir, lms, nco, planar
from radiodsp_sdr_rx_tpu_torch.ops.chain_common import matmul_fp32
from radiodsp_sdr_rx_tpu_torch.ops.spectral_sub import (
    FLOOR_BETA,
    UNDER_FLOOR_GAIN,
    VAD_END_BIN,
    VAD_START_BIN,
    spectral_matmul_ops,
)
from radiodsp_sdr_rx_tpu_torch.parallel import collectives
from radiodsp_sdr_rx_tpu_torch.parallel.mesh import Mesh

FS = 44117.64706
HALOS = ("ppermute", "kernel")


def _check_halo(halo: str) -> None:
    if halo not in HALOS:
        raise ValueError(f"halo must be one of {HALOS}, got {halo!r}")


def _shift_from_left(tails, axis, first_tail):
    """Ring halo: every shard receives its LEFT neighbour's tail, the first
    shard ``first_tail`` (the stream-start carry)."""
    return axis.shift_from_left(tails, first_tail)


def _last_shard_value(vals, axis):
    """The LAST time shard's value on every shard (the stream's final carry)."""
    return axis.last_shard_value(vals)


def _each(v, n: int) -> list:
    """A replicated value as the per-shard list the sharded functions take."""
    return v if isinstance(v, list) else [v] * n


def sharded_overlap_save(xs, w, first_tail, axis, halo: str = "ppermute"):
    """Overlap-save filtering of a time-sharded complex stream.

    xs: the local shards (..., n_local); w: the collapsed operator (2F, F);
    first_tail: (..., F/2) the stream-start carry, one tensor or the
    per-shard list of a replicated one (each line's first shard's counts).
    ``halo``: "ppermute" (the collective) or "kernel" (K9,
    ``parallel/halo.py``). Returns (ys, each shard's own last F/2 samples);
    the last shard's is the stream's next carry. The halo is read here, right
    after its exchange: on a process group's card K9 hands back a receive
    slot that is valid only until the exchange after next."""
    _check_halo(halo)
    half = _each(first_tail, 1)[0].shape[-1]
    my_tails = [x[..., -half:].contiguous() for x in xs]
    tails = axis.shift_from_left(my_tails, first_tail, kernel=halo == "kernel")
    ys = [fastconv.overlap_save_filter(x, w.to(x.device), t)[0] for x, t in zip(xs, tails)]
    return ys, my_tails


def sharded_first_order_iir(xs, a, b, y0, axis):
    """Exact time-sharded y[n] = a*y[n-1] + b*x[n], y[-1] = y0 (a scalar or
    tensor, or its per-shard list).

    Each shard solves from zero; its boundary is the affine map y_out =
    a^n_local * y_in + B_s, so the true starts come from the gathered B's."""
    n_local = xs[0].shape[-1]
    locs = [iir.first_order_iir(x, a, b, torch.zeros_like(x[..., 0])) for x in xs]
    gathered = axis.all_gather([b_s for _, b_s in locs])
    out = []
    for (y_local, _), all_b, idx, x, y0_s in zip(locs, gathered, axis.indices, xs,
                                                 _each(y0, len(xs))):
        f32 = dict(dtype=x.dtype, device=x.device)
        a_t = torch.as_tensor(a, **f32)
        decay = a_t ** n_local
        seg = torch.arange(axis.size, device=x.device)
        gap = idx - 1 - seg
        powers = torch.where(gap >= 0, decay ** gap.to(x.dtype), 0.0)
        mask = (seg < idx).to(x.dtype)
        y0_t = torch.as_tensor(y0_s, **f32)
        init = (torch.tensordot(powers * mask, all_b, dims=([0], [0]))
                + y0_t * decay ** torch.tensor(float(idx), **f32))
        k = torch.arange(n_local, **f32)
        out.append(y_local + init[..., None] * a_t ** (k + 1.0))
    return out


def sharded_agc_envelope(mags, env0, release, axis):
    """Exact time-sharded env[n] = max(mag[n], env[n-1]*release) by the same
    two-level scheme in the (max, +log-decay) algebra; env0 a scalar or
    tensor, or its per-shard list."""
    n_local = mags[0].shape[-1]
    dev0 = dict(dtype=torch.float32, device=mags[0].device)
    d = -torch.log(torch.tensor(float(np.float32(release)), **dev0))
    floor = torch.exp(torch.tensor(agc_ops._LOG_FLOOR, **dev0))
    locs = [agc_ops.agc_envelope(m, torch.full_like(m[..., 0], float(floor)), release)
            for m in mags]
    lls = [torch.log(torch.maximum(last, floor.to(last.device))) for _, last in locs]
    out = []
    for (env_local, _), all_ll, idx, m, env0_s in zip(locs, axis.all_gather(lls), axis.indices,
                                                      mags, _each(env0, len(mags))):
        f32 = dict(dtype=torch.float32, device=m.device)
        d_m, floor_m = d.to(m.device), floor.to(m.device)
        seg = torch.arange(axis.size, device=m.device)
        bshape = (axis.size,) + (1,) * (all_ll.dim() - 1)
        gap = ((idx - 1 - seg).to(torch.float32) * (n_local * d_m)).reshape(bshape)
        cand = torch.where((seg < idx).reshape(bshape), all_ll - gap,
                           torch.tensor(agc_ops._LOG_FLOOR, **f32))
        l0 = torch.log(torch.maximum(torch.as_tensor(env0_s, **f32), floor_m))
        linit = torch.maximum(cand.max(dim=0).values,
                              l0 - torch.tensor(float(idx), **f32) * n_local * d_m)
        k = torch.arange(n_local, **f32)
        out.append(torch.maximum(env_local, torch.exp(linit[..., None] - (k + 1.0) * d_m)))
    return out


def _tensor(x, dtype, device=None) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return x.to(device=device, dtype=dtype)


def _front(xs, incs, phase_base, sb_tail0, dc0, nbavg0, w_sb, axis, *, mode: str,
           noise_blanker: bool = False, nb_a: float = 0.0, nb_th: float = 0.0,
           halo: str = "ppermute"):
    """The linear front of one line: [blanker], mix, band-pass with the halo,
    then SSB demod, the AM envelope through the DC blocker, or (SAM) the
    band-passed z. Returns (audio, sb_tail1, dc1, nbavg1), the carries the
    last shard's, on every shard."""
    n_local = xs[0].shape[-1]
    nbavg1 = nbavg0
    if noise_blanker:
        mags = [x.abs() for x in xs]
        avg = sharded_first_order_iir(mags, nb_a, 1.0 - nb_a, nbavg0, axis)
        th = float(np.float32(nb_th))
        xs = [torch.where(m <= v * th + 1e-12, x, 0.0) for x, m, v in zip(xs, mags, avg)]
        nbavg1 = _last_shard_value([v[..., -1] for v in avg], axis)
    z = [nco.nco_mix(x, (p + nco.mul_u32(idx * n_local, inc)) & nco.PHASE_MASK, inc)[0]
         for x, p, inc, idx in zip(xs, phase_base, incs, axis.indices)]
    z, my_tails = sharded_overlap_save(z, w_sb, sb_tail0, axis, halo)
    sb_tail1 = _last_shard_value(my_tails, axis)
    dc1 = dc0
    if mode == "am":
        env = [v.abs() for v in z]
        prev = _shift_from_left([e[..., -1:] for e in env], axis, [d[..., 0:1] for d in dc0])
        x_prev = [torch.cat([p, e[..., :-1]], dim=-1) for p, e in zip(prev, env)]
        audio = sharded_first_order_iir([e - xp for e, xp in zip(env, x_prev)], iir.DC_POLE,
                                        1.0, [d[..., 1] for d in dc0], axis)
        dc1 = _last_shard_value([torch.stack([e[..., -1], a[..., -1]], dim=-1)
                                 for e, a in zip(env, audio)], axis)
    elif mode == "usb":
        audio = [demod.demod_ssb(v) for v in z]
    else:
        audio = z
    return audio, sb_tail1, dc1, nbavg1


def _agc_pbt(audio, atail0, env0, w_audio, axis, agc, out_gain: float,
             halo: str = "ppermute"):
    """The AGC with its exact sharded envelope, then PBT (z = L + jR, L = R)
    with the halo. Returns (L, R, audio_tail1, env1)."""
    envl = sharded_agc_envelope([a.abs() for a in audio], env0, agc.release, axis)
    if agc.enabled:
        audio = [a * torch.clamp(float(agc.target) / e.clamp(min=1e-12), max=float(agc.max_gain))
                 for a, e in zip(audio, envl)]
    env1 = _last_shard_value([e[..., -1] for e in envl], axis)
    za, my_tails = sharded_overlap_save([torch.complex(a, a) for a in audio], w_audio,
                                        atail0, axis, halo)
    return ([v.real * out_gain for v in za], [v.imag * out_gain for v in za],
            _last_shard_value(my_tails, axis), env1)


def _agc(release, target, max_gain, enabled=True) -> agc_ops.AGCParams:
    f = lambda v: float(np.float32(v))   # noqa: E731  the JAX chain's f32 params
    return agc_ops.AGCParams(release=f(release), target=f(target), max_gain=f(max_gain),
                             enabled=bool(enabled))


def make_time_sharded_ssb_chain(mesh: Mesh, *, axis_name: str = "time", am: bool = False,
                                sample_rate: float = FS, halo: str = "ppermute"):
    """A time-sharded full chain of one stream (NCO, sideband filter, SSB or
    AM demod, AGC, PBT), exact against the unsharded chain to f32 rounding.

    Returns fn(iq (n,) complex64, nco_inc, w_sb, w_audio, agc_release,
    agc_target, agc_max_gain, output_gain) -> audio (n,), iq split over
    ``axis_name``. ``halo``: "ppermute" or "kernel" (K9) for both
    overlap-save halos."""
    _check_halo(halo)

    def fn(iq, nco_inc, w_sb, w_audio, agc_release, agc_target, agc_max_gain, output_gain):
        iq = _tensor(iq, torch.complex64)
        spec = {axis_name: iq.dim() - 1}
        agc = _agc(agc_release, agc_target, agc_max_gain)
        w_sb, w_audio = _tensor(w_sb, torch.float32), _tensor(w_audio, torch.float32)
        coords, axis = mesh.lines(axis_name, first_only=True)
        xs = [mesh.shard(iq, spec, c) for c in coords]
        devs = [x.device for x in xs]
        incs = [torch.tensor(int(nco_inc), device=d) for d in devs]
        tails = [torch.zeros(w_sb.shape[1] // 2, dtype=torch.complex64, device=d) for d in devs]
        dc0 = [torch.zeros(2, device=d) for d in devs]
        env0 = [torch.tensor(1e-6, device=d) for d in devs]
        audio = _front(xs, incs, [0] * len(xs), tails, dc0, None, w_sb, axis,
                       mode="am" if am else "usb", halo=halo)[0]
        audio = _agc_pbt(audio, tails, env0, w_audio, axis, agc,
                         float(np.float32(output_gain)), halo)[0]
        out = dict(zip(coords, audio))
        return mesh.unshard(out, spec)

    return fn


def make_bank_time_sharded_chain(mesh: Mesh, *, channel_axis: str = "channel",
                                 time_axis: str = "time", am: bool = False,
                                 sample_rate: float = FS):
    """The 2-D sharded bank: channels over ``channel_axis``, time over
    ``time_axis`` (ppermute halos).

    Returns fn(iq (C, T), nco_inc (C,), w_sb, w_audio, agc_release,
    agc_target, agc_max_gain, agc_enabled, output_gain) -> audio (C, T)."""

    chain = make_full_sharded_chain(mesh, mode="am" if am else "usb", nr="off",
                                    channel_axis=channel_axis, time_axis=time_axis,
                                    sample_rate=sample_rate)

    def fn(iq, nco_inc, w_sb, w_audio, agc_release, agc_target, agc_max_gain, agc_enabled,
           output_gain):
        st = sharded_chain_init(int(np.shape(iq)[0]), np.shape(w_sb)[1] // 2)
        return chain(iq, nco_inc, st, w_sb, w_audio, agc_release, agc_target, agc_max_gain,
                     agc_enabled, output_gain)[0]

    return fn


class ShardedChainState(NamedTuple):
    """Mid-stream carry of the full sharded chain, field for field the JAX
    ``ShardedChainState``: the ``ReceiverState`` carries in the chain's
    complex layout, every leaf with the channel axis first. DDS words are
    int64 in [0, 2^32); the LMS ``first`` flag is (C,), run as all(first)."""

    nco_phase: torch.Tensor    # (C,) int64 DDS phase at segment start
    sb_tail: torch.Tensor      # (C, half) complex64 MIXED-stream overlap carry
    audio_tail: torch.Tensor   # (C, half) complex64 PBT-stage overlap carry
    agc_env: torch.Tensor      # (C,) f32
    am_dc: torch.Tensor        # (C, 2) f32 DC-blocker carry [last in, last out]
    sam_phase: torch.Tensor    # (C,) f32
    sam_freq: torch.Tensor     # (C,) f32
    lms: lms.LMSState          # (C, ...) leaves
    nfloor: torch.Tensor       # (C,) f32 spectral noise-floor carry
    spec_tail_l: torch.Tensor  # (C, half) f32 spectral frame carries (post-PBT L)
    spec_tail_r: torch.Tensor  # (C, half) f32
    nb_avg: torch.Tensor       # (C,) f32 noise-blanker running-average carry


def sharded_chain_init(n_channels: int, half: int = 128, device="cpu") -> ShardedChainState:
    """A fresh state (the chain moves each leaf to its shards' devices)."""
    c = n_channels

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(c, *shape, dtype=dtype, device=device)

    return ShardedChainState(
        nco_phase=zeros(dtype=torch.int64), sb_tail=zeros(half, dtype=torch.complex64),
        audio_tail=zeros(half, dtype=torch.complex64),
        agc_env=torch.full((c,), 1e-6, device=device), am_dc=zeros(2), sam_phase=zeros(),
        sam_freq=zeros(), lms=lms.lms_nr_init(c, device=device), nfloor=zeros(),
        spec_tail_l=zeros(half), spec_tail_r=zeros(half), nb_avg=zeros())


def _map(fn, state):
    """``fn`` on every tensor of a (nested) state."""
    return type(state)(*(_map(fn, v) if isinstance(v, tuple) else fn(v) for v in state))


def _to_adaptive_layout(xs, axis):
    """(C_loc, T_loc) -> (C_loc/tdim, T_global) per shard, one all_to_all
    over the time axis: each shard gets whole streams of a sub-bank."""
    c_loc = xs[0].shape[0]
    if c_loc % axis.size:
        raise ValueError(f"local channels {c_loc} not divisible by time mesh dim {axis.size}")
    return axis.all_to_all(xs, 0, 1)


def _from_adaptive_layout(ys, axis):
    """Inverse of ``_to_adaptive_layout``."""
    return axis.all_to_all(ys, 1, 0)


def _per_shard(fn, axis, *lists):
    """fn(*args) for each shard's args, tuples of tensors back. In one
    process, when every shard of the mesh's lines is on one device, one call
    on all the shards' arguments stacked along dim 0 (the adaptive stages are
    independent per channel, so a channel's result does not depend on its
    neighbours)."""
    devs = {a.device for a in lists[0]}
    if isinstance(axis, collectives.LocalAxis) and len(devs) == 1 and len(lists[0]) > 1:
        sizes = [a.shape[0] for a in lists[0]]
        outs = fn(*(torch.cat(list(args), dim=0) for args in lists))
        return list(zip(*(o.split(sizes, dim=0) for o in outs)))
    return [fn(*args) for args in zip(*lists)]


def _spectral(l, r, nfl0, stl0, str0, axis, w_fwd, w_inv, spec_gain: float):
    """The post-PBT spectral subtraction of one line: frames cross the seams
    through the ppermute halo, the floor's one-pole through the affine
    fix-up. Returns (L, R, nfloor1, spec_tail_l1, spec_tail_r1)."""
    prev_l = _shift_from_left([v[..., -128:] for v in l], axis, stl0)
    prev_r = _shift_from_left([v[..., -128:] for v in r], axis, str0)
    scale_est = float(np.float32(spec_gain))
    ests, frames = [], []
    for lv, rv, pl, pr in zip(l, r, prev_l, prev_r):
        c, n = lv.shape
        fl, fr = lv.reshape(c, n // 128, 128), rv.reshape(c, n // 128, 128)
        pl_rows = torch.cat([pl[:, None], fl[:, :-1]], dim=1)
        pr_rows = torch.cat([pr[:, None], fr[:, :-1]], dim=1)
        spec = matmul_fp32(torch.cat([pl_rows, fl, pr_rows, fr], dim=-1), w_fwd.to(lv.device))
        sr, si = spec[..., :256], spec[..., 256:]
        mag = torch.sqrt(sr * sr + si * si)
        ests.append(mag[..., VAD_START_BIN:VAD_END_BIN + 1].sum(-1) * scale_est)
        frames.append((sr, si, mag))
    nfl = [v.clamp(min=0.0) for v in
           sharded_first_order_iir(ests, 1.0 - FLOOR_BETA, FLOOR_BETA, nfl0, axis)]
    outs_l, outs_r = [], []
    for (sr, si, mag), nf, lv in zip(frames, nfl, l):
        nf = nf[..., None]
        scale = torch.where(mag <= nf, UNDER_FLOOR_GAIN, 1.0 - nf / mag.clamp(min=1e-20))
        y = matmul_fp32(torch.cat([sr * scale, si * scale], dim=-1), w_inv.to(lv.device))
        outs_l.append(y[..., :128].reshape(lv.shape))
        outs_r.append(y[..., 128:].reshape(lv.shape))
    return (outs_l, outs_r, _last_shard_value([v[..., -1] for v in nfl], axis),
            _last_shard_value([v[..., -128:] for v in l], axis),
            _last_shard_value([v[..., -128:] for v in r], axis))


def _full_chain(mesh, mode, nr, channel_axis, time_axis, sample_rate, lms_mu, nr_level,
                noise_blanker, nb_tau, nb_threshold_db):
    if mode not in ("usb", "am", "sam"):
        raise ValueError(mode)
    if nr not in ("off", "lms", "notch", "spectral"):
        raise ValueError(nr)
    w_fwd, w_inv = (torch.from_numpy(w) for w in spectral_matmul_ops(256))
    spec_gain = float(nr_level) * 1.5 / float(VAD_END_BIN - VAD_START_BIN)
    nb_a = float(math.exp(-1.0 / nb_tau)) if noise_blanker else 0.0
    nb_th = float(10.0 ** (nb_threshold_db / 20.0)) if noise_blanker else 0.0
    adaptive = mode == "sam" or nr in ("lms", "notch")

    def line(xs, incs, st, axis, w_sb, w_audio, agc, out_gain):
        n_total = xs[0].shape[-1] * axis.size
        sub = xs[0].shape[0] // axis.size
        audio, sb1, dc1, nbavg1 = _front(
            xs, incs, [s.nco_phase for s in st], [s.sb_tail for s in st],
            [s.am_dc for s in st], [s.nb_avg for s in st], w_sb, axis, mode=mode,
            noise_blanker=noise_blanker, nb_a=nb_a, nb_th=nb_th)
        sam_p1, sam_f1 = [s.sam_phase for s in st], [s.sam_freq for s in st]
        lms1 = [s.lms for s in st]

        def take(leaves):
            return [v[i * sub:(i + 1) * sub] for v, i in zip(leaves, axis.indices)]

        def put(subs):
            return [g.flatten(0, 1) for g in axis.all_gather(subs)]

        def run_lms(x, lms_mode):
            def one(xv, w, win, dly, first):
                out, s1 = lms.lms_nr_run(xv, lms.LMSState(w, win, dly, first), lms_mu, lms_mode)
                return (out, *s1)

            res = _per_shard(one, axis, _to_adaptive_layout(x, axis),
                             *(take([getattr(s.lms, f) for s in st]) for f in lms.LMSState._fields))
            state = [lms.LMSState(*v) for v in zip(*(put([r[k] for r in res])
                                                     for k in range(1, 5)))]
            return _from_adaptive_layout([r[0] for r in res], axis), state

        if mode == "sam":
            def one_sam(zr, zi, p, f, d):
                out, s1 = planar.demod_sam_planar(zr, zi, planar.SAMStatePlanar(p, f, d),
                                                  sample_rate=sample_rate)
                return (out, *s1)

            a2 = _to_adaptive_layout(audio, axis)
            res = _per_shard(one_sam, axis, [v.real.contiguous() for v in a2],
                             [v.imag.contiguous() for v in a2], take(sam_p1), take(sam_f1),
                             take([s.am_dc for s in st]))
            audio = _from_adaptive_layout([r[0] for r in res], axis)
            sam_p1, sam_f1, dc1 = (put([r[k] for r in res]) for k in (1, 2, 3))
        if nr == "notch":
            audio, lms1 = run_lms(audio, "notch")

        audio, audio_r, at1, env1 = _agc_pbt(audio, [s.audio_tail for s in st],
                                             [s.agc_env for s in st], w_audio, axis, agc,
                                             out_gain)
        nfl1 = [s.nfloor for s in st]
        stl1, str1 = [s.spec_tail_l for s in st], [s.spec_tail_r for s in st]
        if nr == "spectral":
            audio, audio_r, nfl1, stl1, str1 = _spectral(
                audio, audio_r, nfl1, stl1, str1, axis, w_fwd, w_inv, spec_gain)
        if nr == "lms":
            audio, lms1 = run_lms(audio, "denoise")
            audio = [a * 1.1 for a in audio]
        states = [ShardedChainState(
            nco_phase=(s.nco_phase + nco.mul_u32(n_total % (1 << 32), inc)) & nco.PHASE_MASK,
            sb_tail=sb, audio_tail=at, agc_env=env, am_dc=dc, sam_phase=sp, sam_freq=sf,
            lms=lm, nfloor=nf, spec_tail_l=tl, spec_tail_r=tr, nb_avg=nb)
            for s, inc, sb, at, env, dc, sp, sf, lm, nf, tl, tr, nb in zip(
                st, incs, sb1, at1, env1, dc1, sam_p1, sam_f1, lms1, nfl1, stl1, str1, nbavg1)]
        return audio, states

    def fn(iq, incs, state0: ShardedChainState, w_sb, w_audio, agc_release, agc_target,
           agc_max_gain, agc_enabled, output_gain):
        iq = _tensor(iq, torch.complex64)
        incs = _tensor(incs, torch.int64)
        state0 = _map(lambda t: t if torch.is_tensor(t) else _tensor(
            t, torch.int64 if np.asarray(t).dtype == np.uint32 else None), state0)
        if adaptive and (iq.shape[0] // mesh.shape[channel_axis]) % mesh.shape[time_axis]:
            raise ValueError(f"the adaptive stages need (C / channel) % time == 0, got C = "
                             f"{iq.shape[0]} on a {mesh.shape} mesh")
        agc = _agc(agc_release, agc_target, agc_max_gain, agc_enabled)
        w_sb, w_audio = _tensor(w_sb, torch.float32), _tensor(w_audio, torch.float32)
        blocks, per_ch = {channel_axis: 0, time_axis: 1}, {channel_axis: 0}
        coords, axis = mesh.lines(time_axis)
        xs = [mesh.shard(iq, blocks, c) for c in coords]
        st = [mesh.shard_state(state0, per_ch, c) for c in coords]
        audio, st1 = line(xs, [mesh.shard(incs, per_ch, c) for c in coords], st, axis,
                          w_sb, w_audio, agc, float(np.float32(output_gain)))
        return (mesh.unshard(dict(zip(coords, audio)), blocks),
                mesh.unshard_state(dict(zip(coords, st1)), per_ch))

    return fn


def make_full_sharded_chain(mesh: Mesh, *, mode: str = "usb", nr: str = "off",
                            channel_axis: str = "channel", time_axis: str = "time",
                            sample_rate: float = FS, lms_mu: float = 0.0316,
                            nr_level: float = 30.0, noise_blanker: bool = False,
                            nb_threshold_db: float = 10.0, nb_tau: float = 512.0):
    """The complete 2-D sharded chain: channels over ``channel_axis``, time
    over ``time_axis``, the adaptive stages included.

      - the linear stages (blanker, NCO, overlap-save filters, AGC envelope,
        DC blocker) time-sharded with ppermute halos and exact fix-ups;
      - the adaptive stages (the SAM PLL, ``planar.demod_sam_planar``,
        ``sam_exact`` on the card; the
        LMS notch before the AGC or denoise after PBT, ``lms.lms_nr_run``,
        K3 on the card) after an all_to_all that gives each shard whole
        streams of C_loc / time channels, then the inverse all_to_all;
      - the spectral subtraction after PBT, frame-parallel, its floor's
        one-pole through the affine fix-up.

    mode: "usb" | "am" | "sam"; nr: "off" | "lms" | "notch" | "spectral".
    The adaptive stages need (C / channel) % time == 0 (ValueError).

    Returns fn(iq (C, T) complex64, incs (C,), state0: ShardedChainState,
    w_sb, w_audio, agc_release, agc_target, agc_max_gain, agc_enabled,
    out_gain) -> (audio (C, T), state1), equal to the unsharded per-channel
    chain (input gain 1, balance 1, not muted) to f32 rounding, from and to
    a mid-stream state."""
    return _full_chain(mesh, mode, nr, channel_axis, time_axis, sample_rate, lms_mu,
                       nr_level, noise_blanker, nb_tau, nb_threshold_db)


def sharded_panadapter(mesh: Mesh, *, axis_name: str = "time", naverage: int = 30):
    """The panadapter of a time-sharded stream: each shard frames its own
    segment (the halo carries the previous shard's last block), and the
    magnitude-squared rows are averaged over the shards with ``psum``.

    Returns fn(iq (n,) complex64) -> (n_updates_per_shard, 256) rows, each
    the average of naverage * shards frames."""

    def fn(iq):
        iq = _tensor(iq, torch.complex64)
        spec = {axis_name: iq.dim() - 1}
        coords, axis = mesh.lines(axis_name, first_only=True)
        xs = [mesh.shard(iq, spec, c) for c in coords]
        tails = _shift_from_left([x[..., -128:] for x in xs], axis,
                                 torch.zeros(128, dtype=iq.dtype))
        rows = [analyzers.iq_spectrum_frames(x, naverage=naverage, tail=t)
                for x, t in zip(xs, tails)]
        total = axis.psum([r * r for r in rows])
        return torch.sqrt(total[0] / axis.size)

    return fn


def shard_channel_bank(bank, mesh: Mesh, axis_name: str = "channel"):
    """Split a port ``ReceiverBank`` by channel over the mesh axis
    ``axis_name``: one bank per shard, on its device, with its channels'
    DDS increments. Returns process(iq (C, n), state) -> (out, state'),
    the shards' results concatenated, as ``bank.process``."""
    n_dev = mesh.shape[axis_name]
    if bank.n_channels % n_dev:
        raise ValueError(f"{bank.n_channels} channels not divisible by {n_dev} "
                         f"'{axis_name}' shards")
    per_ch = {axis_name: 0}
    coords, _ = mesh.lines(axis_name, first_only=True)
    shards = {}
    for c in coords:
        sub = copy.copy(bank)
        sub.device = mesh.device(c)
        sub.n_channels = bank.n_channels // n_dev
        sub.params = bank.params._replace(**{
            k: mesh.shard(v, per_ch, c) if k == "nco_inc" else v.to(sub.device)
            for k, v in bank.params._asdict().items() if torch.is_tensor(v)})
        shards[c] = sub

    def process(iq, state):
        iq = _tensor(iq, torch.complex64)
        if iq.dim() == 1:
            iq = iq.expand(bank.n_channels, -1)
        outs, states = {}, {}
        for c, sub in shards.items():
            part = mesh.shard(iq, per_ch, c)
            outs[c], states[c] = sub.process_planar(part.real.contiguous(),
                                                    part.imag.contiguous(),
                                                    mesh.shard_state(state, per_ch, c))
        return ({k: mesh.unshard({c: o[k] for c, o in outs.items()}, per_ch)
                 for k in ("audio_l", "audio_r")}, mesh.unshard_state(states, per_ch))

    return process
