#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's kernels from ``radiodsp_sdr_rx_tpu_torch/csrc`` with nvcc
(one nvcc per source, all started together), holds each kernel against its
plain PyTorch version, drives every ported path at full width (2^19-sample
segments, state threaded between them) through the kernels, holds the fused
banks against the port's reference chain, and times them:

  - the main path, the 128-channel USB ``FusedSSBBank`` of bench.py,
    backend="sweep": kernel sweep_chain_ssb, 1 launch/segment;
  - the staged path, backend="staged": kernels mix_demod and pbt with the AGC
    between them in PyTorch, 2 launches/segment;
  - the noise-blanker path, noise_blanker=True: kernel sweep_chain_ssb_nb,
    1 launch/segment;
  - the AM path, ``FusedAMBank`` at bench_full.py's config1 (64 channels, AGC
    off): kernel sweep_chain_am, 1 launch/segment, and with the blanker
    sweep_chain_am_nb;
  - the reference chain, ``ReceiverBank(backend="batched")`` at bench_full.py's
    config3 (CW_NARROW, NR notch) and config7 (USB, DNR2), 128 channels: its
    LMS stage on kernel lms_nr, 1 launch/segment, the other stages plain
    PyTorch;
  - the NR bank, ``FusedNRBank``: at bench_full.py's config4 (USB, SPEC2, 64
    channels) ``fold=True`` on kernel sweep_spec_chain (K4), 1 launch/segment,
    and ``fold=False`` on sweep_chain_ssb, 1 launch/segment, with the spectral
    stage plain PyTorch, beside ``ReceiverBank`` at config4 (no kernel); at
    config7 ``fold=False`` on sweep_chain_ssb_mono + lms_nr, and at config3
    ``fold=False`` on mix_demod + lms_nr + pbt, 1 launch each per segment;
  - the folded NR bank on the lanes kernel's NR instantiations, 1
    launch/segment: bench_full.py's config3 (CW + notch, lanes_ssb_notch),
    config7 (USB + DNR2, lanes_ssb_denoise) and config8 (AM + DNR2,
    lanes_am_denoise) at 128 channels x 2^19, and the other fourteen
    routes (every demod x NR x blanker) at 128 channels x 2^17; each kernel
    against its plain chain on a prefix (LMS_PREFIX samples, SAM_PREFIX
    with SAM), each bank against ``ReceiverBank``, configs 3 and 7 folded
    against staged;
  - cross-path parity: the fused SSB, AM and NR banks against
    ``ReceiverBank`` on the same input, at the docs/CHIP_PARITY.md bound;
  - the SAM bank, ``FusedSAMBank``, on locked-carrier scenes (every channel
    on its own AM carrier; the PLL is chaotic on noise): at bench_full.py's
    config6 (128 channels, AGC medium) ``fold=False`` on kernels sam_pll (K5)
    and pbt, 1 launch each per segment, ``fold=True`` on sweep_chain_sam
    (K6) and with the blanker sweep_chain_sam_nb, 1 launch/segment; at
    config10 (1,024 channels, 2^17-sample segments) on sam_wide (K7, 8
    channels a block) and with the blanker sam_wide_nb, 1 launch/segment.
    Each kernel against its plain version on a full-width prefix of
    SAM_PREFIX samples (the plain PLL is one host-bound step per sample):
    threaded as two segments, and the full run's first samples; each route
    against ``ReceiverBank(mode=SAM)`` on a prefix; K7 against K6 at
    1,024 channels over two full segments.

Every phase prints one flushed line with the seconds elapsed. Any failure
raises and exits non-zero; without a CUDA card it exits non-zero at once.
The last line is {"ok": true, "device": {...}}; the line before it is the
per-kernel JSON record.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

T0 = time.perf_counter()
TOL = 1e-4           # kernel vs plain, both fp32: sums taken in another order
TOL_BACKENDS = 2e-4  # staged vs sweep backend (tests/test_fused_bank.py:66-88)
TOL_LMS = 2e-4       # the LMS twin bound (tests/test_pallas_lms.py:35)
TOL_PARITY = 2e-3    # fused bank vs ReceiverBank (docs/CHIP_PARITY.md)
# Spectral NR scales a bin by 0.2 at or under the floor and by 1 - nf/mag,
# about 0, just above it: a bin within rounding of the floor may take either
# side in two summation orders. Bins within FLIP_MARGIN (relative) of the
# floor are counted per frame; the measured relative rounding of mag and nf
# is about 1e-6.
FLIP_MARGIN = 1e-4
N_CHANNELS = 128     # bench.py:38
N_SAM = 128          # bench_full.py config6_sam_128ch
N_SAM_WIDE = 1024    # bench_full.py config10_sam_1024ch
SEG_WIDE = 1 << 17   # config10's segment (bench_full.py seg_override)
SEG_NR = 1 << 17     # the NR routes beside configs 3, 7 and 8 (a cut, PERF.md section 4)
SAM_PREFIX = 2048    # samples of the per-sample plain PLL held to the kernels
N_AM = 64            # bench_full.py config1_am_64ch
N_SPEC = 64          # bench_full.py config4_spec_nr_64ch
SEG_LEN = 1 << 19    # bench.py:39
SEGMENTS = 3         # threaded segments of each full-width run
REPS = 10            # timed segments
LMS_PREFIX = 16384   # samples of the per-sample plain LMS held to the kernel
PEAK_BYTES_S = 3.35e12   # H100 SXM device memory
PEAK_FP32_S = 67e12      # H100 SXM fp32 outside the tensor cores
NB_FLOPS_PER_SAMPLE = 10  # |x|, the one-pole average, the threshold test
AM_FLOPS_PER_SAMPLE = 6   # the envelope and the DC blocker
DC_FLOPS_PER_SAMPLE = 3   # the DC blocker alone
LMS_FLOPS_PER_SAMPLE = 6 * 96   # the 96-tap dot, the energy and the update
# K4: the chain's two products (2,048), W_fwd (4,096) and W_inv (2,048)
SPEC_FLOPS_PER_SAMPLE = 2 * (512 * 128 + 256 * 256 + 512 * 512 + 512 * 256) // 128
# the PLL step: the two products, the atan2 (a divide counted as one), the
# loop update, the base oscillator's two Horner chains, the rotation
PLL_FLOPS_PER_SAMPLE = 72
LIBRARIES = ("sweep_chain", "staged", "lms", "sweep_spec", "sam", "sam_wide", "sweep_denoise",
             "sweep_notch")


def say(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f} s] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def max_diff(got, ref) -> float:
    return max(float((g - r).abs().max()) for g, r in zip(got, ref))


def time_ms(fn, reps: int, warmup: bool = True) -> float:
    if warmup:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def noise(shape, gen, scale=0.1):
    return torch.randn(shape, generator=gen, device="cuda") * scale


def nb_scene(c, n, gen):
    """The decisive noise-blanker scene of tests/test_fused_bank.py:496-545:
    noise with a 2x burst (the AGC attacks, then releases), its magnitude
    clipped to 2.2x its mean so that no noise sample lies near the blanking
    threshold, and impulses of 8(1+1j) far above it, one on the last sample.
    Returns (xr, xi, mean magnitude), the last to warm-start the average."""
    xr, xi = noise((c, n), gen, 0.05), noise((c, n), gen, 0.05)
    xr[:, n // 3:n // 3 + 400] *= 2.0
    xi[:, n // 3:n // 3 + 400] *= 2.0
    mag = torch.hypot(xr, xi)
    f = (2.2 * mag.mean() / mag.clamp(min=1e-12)).clamp(max=1.0)
    xr, xi = xr * f, xi * f
    for pos in (500, 1733, n // 2 + 7, n - 3, n - 1):
        xr[:, pos] = 8.0
        xi[:, pos] = 8.0
    return xr, xi, float(torch.hypot(xr, xi).mean())


def tone_scene(c, n, gen):
    """A tone per channel (predictable across the LMS's 128-sample delay) in
    noise: what the LMS stages adapt to."""
    t = torch.arange(n, device="cuda", dtype=torch.float32)
    f = torch.rand((c, 1), generator=gen, device="cuda") * 0.2 + 0.01
    return 0.3 * torch.sin(2 * torch.pi * f * t) + noise((c, n), gen)


def kernel_of(demod: int, nb: bool, nr: int, stereo: bool) -> str:
    """The reported name of an instantiation of csrc/sweep_chain.cuh's kernel."""
    d = ("ssb", "am", "sam")[demod]
    if nr == 0:
        return f"sweep_chain_{d}{'_nb' if nb else ''}{'' if stereo else '_mono'}"
    if (d, nr, nb) == ("ssb", 3, False):
        return "sweep_spec_chain"
    return f"lanes_{d}_{('denoise', 'notch', 'spectral')[nr - 1]}{'_nb' if nb else ''}"


def ptxas_summary(log: str):
    """(kernel, registers, stack and spills) per entry function of a build
    log, the chain kernel's instantiations (demod x blanker x NR stage x R
    output) and the wide SAM kernel's (channels a block x blanker) by entry
    point."""
    out = []
    for block in log.split("Compiling entry function")[1:]:
        mangled = block.split("'")[1]
        if "sweep_chain_kernel" in mangled:
            demod, nb, nr, stereo = re.search(r"DemodE(\d)ELb(\d)EL\w*?NrE(\d)ELb(\d)E",
                                              mangled).groups()
            kname = kernel_of(int(demod), nb == "1", int(nr), stereo == "1")
        elif "sam_wide_kernel" in mangled:
            g, nb = re.search(r"sam_wide_kernelILi(\d)ELb(\d)E", mangled).groups()
            kname = f"sam_wide{'_nb' if nb == '1' else ''} (G={g})"
        else:
            kname = next(k for fn, k in (("mix_demod_kernel", "mix_demod"), ("pbt_kernel", "pbt"),
                                         ("lms_kernel", "lms_nr"),
                                         ("sam_pll_kernel", "sam_pll"))
                         if fn in mangled)
        lines = block.splitlines()
        out.append((kname, next(ln for ln in lines if "registers" in ln).split(": ")[-1],
                    next(ln for ln in lines if "spill" in ln).strip()))
    return out


def floor_margins(args, sweep):
    """Per 128-sample frame (C, rows) of the plain spectral chain on these
    ``lanes.sweep_lanes_chain`` arguments: the number of bins within
    FLIP_MARGIN of the floor, and the floor."""
    *chain, dc0, sam_a, _, spec = args
    chain[14] = 1.0   # the spectral stage sees [l | r] before the output gain
    l, r = sweep.chain_plain(*chain, dc0, sam=sam_a)[:2]
    _, _, mag, nfloor = sweep.spectral_floor(l, r, spec.w_fwd, spec.nfloor0, spec.tail_l,
                                             spec.tail_r, spec.nr_level)
    nf = nfloor.clamp(min=0.0)
    return ((mag - nf[..., None]).abs() <= FLIP_MARGIN * nf[..., None]).sum(-1), nf


def spectral_diff(got, ref, near, nf, out_gain, tol):
    """L and R (C, n) against the reference, frame by frame: a frame with no
    bin near the floor must agree to tol; one with k such bins to
    tol + k * 0.2 * nf * out_gain / 256, the most that k scales flipping
    between 0.2 and about 0 move an output sample (the inverse DFT divides by
    256). Returns (the max diff over frames with no bin near the floor, the
    frames with one, how many of those differ by more than tol, all pass)."""
    c = got[0].shape[0]
    d = torch.stack([(g - r).abs().view(c, -1, 128).amax(-1) for g, r in zip(got, ref)]).amax(0)
    clear = d[near == 0]
    ok = bool((d <= tol + near * (0.2 * out_gain / 256) * nf).all())
    return (float(clear.max()) if clear.numel() else 0.0, int((near > 0).sum()),
            int(((near > 0) & (d > tol)).sum()), ok)


def locked_scene(c, n, gen, nco_hz, impulses=False):
    """Planar IQ (c, n) whose row k carries an AM carrier (depth 0.4, a
    400-500 Hz tone) at nco_hz[k] plus up to 50 Hz, so that channel k's own
    mix brings it within 50 Hz of 0 Hz, and 0.02-sigma noise
    (tests/test_pallas_sam.py:46-59; the SAM PLL is chaotic on noise). With
    ``impulses``: 8(1+1j) at five places, one on the last sample, far above
    the blanker's threshold. Returns (xr, xi, mean magnitude)."""
    t = torch.arange(n, device="cuda", dtype=torch.float64) / 44117.64706
    r = torch.rand((c, 3), generator=gen, device="cuda", dtype=torch.float64)
    f = torch.tensor(nco_hz, device="cuda", dtype=torch.float64)[:, None] + (r[:, :1] - 0.5) * 100
    ang = 2 * torch.pi * (f * t + r[:, 2:3])
    env = 1.0 + 0.4 * torch.sin(2 * torch.pi * (400.0 + 100.0 * r[:, 1:2]) * t)
    xr = (env * torch.cos(ang)).float() + noise((c, n), gen, 0.02)
    xi = (env * torch.sin(ang)).float() + noise((c, n), gen, 0.02)
    del t, ang, env
    if impulses:
        for pos in (500, 1733, n // 2 + 7, n - 3, n - 1):
            xr[:, pos] = 8.0
            xi[:, pos] = 8.0
    return xr, xi, float(torch.hypot(xr, xi).mean())


def phase_diff(a, b) -> float:
    """Largest distance between two phase vectors on the circle."""
    d = (a - b).abs() % (2 * torch.pi)
    return float(torch.minimum(d, 2 * torch.pi - d).max())


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32_S, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def main() -> None:

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card")

    # 1. the device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    say(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} card(s))")
    print(smi, flush=True)

    from radiodsp_sdr_rx_tpu_torch.models.config import (
        AGCMode, DemodMode, NRMode, ReceiverConfig)
    from radiodsp_sdr_rx_tpu_torch.models.fused import (
        FusedAMBank, FusedNRBank, FusedSAMBank, FusedSSBBank)
    from radiodsp_sdr_rx_tpu_torch.models.receiver import ReceiverBank
    from radiodsp_sdr_rx_tpu_torch.ops import (
        agc, iir, lanes, lms, lms_bank, planar, sam, sam_wide, staged, sweep, sweep_spec)
    from radiodsp_sdr_rx_tpu_torch.utils import build

    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False

    def reset_counts() -> None:
        sweep.LAUNCHES = sweep.LAUNCHES_NB = sweep.LAUNCHES_AM = sweep.LAUNCHES_AM_NB = 0
        sweep.LAUNCHES_MONO = 0
        staged.LAUNCHES_MIX_DEMOD = staged.LAUNCHES_PBT = 0
        lms_bank.LAUNCHES = 0
        sweep_spec.LAUNCHES = 0
        sam.LAUNCHES = sweep.LAUNCHES_SAM = sweep.LAUNCHES_SAM_NB = 0
        sam_wide.LAUNCHES = sam_wide.LAUNCHES_NB = 0
        lanes.LAUNCHES.update(dict.fromkeys(lanes.LAUNCHES, 0))

    def counts() -> dict:
        return {"sweep_chain_ssb": sweep.LAUNCHES, "sweep_chain_ssb_nb": sweep.LAUNCHES_NB,
                "mix_demod": staged.LAUNCHES_MIX_DEMOD, "pbt": staged.LAUNCHES_PBT,
                "sweep_chain_am": sweep.LAUNCHES_AM, "sweep_chain_am_nb": sweep.LAUNCHES_AM_NB,
                "lms_nr": lms_bank.LAUNCHES, "sweep_chain_ssb_mono": sweep.LAUNCHES_MONO,
                "sweep_spec_chain": sweep_spec.LAUNCHES, "sam_pll": sam.LAUNCHES,
                "sweep_chain_sam": sweep.LAUNCHES_SAM, "sweep_chain_sam_nb": sweep.LAUNCHES_SAM_NB,
                "sam_wide": sam_wide.LAUNCHES, "sam_wide_nb": sam_wide.LAUNCHES_NB,
                **lanes.LAUNCHES}

    def only(**launched) -> dict:
        """The counts of a path that launched these kernels and no other."""
        return {k: launched.get(k, 0) for k in counts()}

    # 2. the kernel builds, one nvcc per source, all at once
    t = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        list(pool.map(build.load_library, LIBRARIES))
    say(f"build: csrc/{{{','.join(LIBRARIES)}}}.cu with nvcc for sm_90a in "
        f"{time.perf_counter() - t:.2f} s")
    for lib in LIBRARIES:
        for kname, regs, spills in ptxas_summary(build.build_log(lib)):
            say(f"ptxas {lib}.cu {kname}: {regs}; {spills}")

    cfg = ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_200_000.0,
                         capture_center_freq=7_190_000.0, agc=AGCMode.MEDIUM)
    cfg_nb = cfg.with_(noise_blanker=True)
    freqs = [7_190_000.0 + 1_000.0 * k for k in range(N_CHANNELS)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = dict.fromkeys(counts(), 0.0)
    launches = dict.fromkeys(counts(), 0)   # summed over every driven path

    # 3. each kernel vs its plain version, 8 channels x 8192, two threaded segments
    small = FusedSSBBank(cfg, freqs[:8])
    state = small.init_state()
    for seg in range(2):
        xr, xi = noise((8, 8192), gen), noise((8, 8192), gen)
        xr[:, 3000:3400] *= 30.0   # a burst: AGC attack, then release
        ref = sweep.sweep_full_chain_plain(*small.chain_args(xr, xi, state))
        out, state = small.process_planar(xr, xi, state)
        torch.cuda.synchronize()
        d = max_diff((out["audio_l"], out["audio_r"], state.audio_tail, state.agc_env), ref)
        say(f"check sweep_chain_ssb 8 ch x 8192, segment {seg}: max |kernel - plain| over "
            f"L, R, audio_tail, env = {d:.3e} (tolerance {TOL:g})")
        check(d <= TOL, f"sweep_chain_ssb disagrees with the plain version: {d:.3e} > {TOL:g}")
        err["sweep_chain_ssb"] = max(err["sweep_chain_ssb"], d)

    small_nb = FusedSSBBank(cfg_nb, freqs[:8])
    xr, xi, mean_mag = nb_scene(8, 8192, gen)
    state = small_nb.init_state()._replace(nb_avg=torch.full((8,), mean_mag, device="cuda"))
    for seg in range(2):
        ref = sweep.sweep_full_chain_plain(*small_nb.chain_args(xr, xi, state))
        out, state = small_nb.process_planar(xr, xi, state)
        torch.cuda.synchronize()
        d = max_diff((out["audio_l"], out["audio_r"], state.audio_tail, state.agc_env,
                      state.nb_avg, state.nb_mask), ref)
        kept = float(state.nb_mask.mean())
        say(f"check sweep_chain_ssb_nb 8 ch x 8192 (impulse scene), segment {seg}: max "
            f"|kernel - plain| over L, R, audio_tail, env, nb_avg, nb_mask = {d:.3e} "
            f"(tolerance {TOL:g}); last block kept {kept:.4f}")
        check(d <= TOL, f"sweep_chain_ssb_nb disagrees with the plain version: {d:.3e} > {TOL:g}")
        check(kept < 1.0, "the impulse on the segment's last sample was not blanked")
        err["sweep_chain_ssb_nb"] = max(err["sweep_chain_ssb_nb"], d)

    small_st = FusedSSBBank(cfg, freqs[:8], backend="staged")
    state = small_st.init_state()
    for seg in range(2):
        xr, xi = noise((8, 8192), gen), noise((8, 8192), gen)
        xr[:, 3000:3400] *= 30.0
        args = small_st.mix_demod_args(xr, xi, state)
        audio = staged.fused_mix_filter_demod_plain(*args)
        d_a = max_diff([staged.fused_mix_filter_demod(*args)], [audio])
        audio_g, env = agc.agc_run(audio, small_st.agc_params, state.agc_env)
        ref = staged.pbt_filter_plain(*small_st.pbt_args(audio_g, state))
        d_b = max_diff(staged.pbt_filter(*small_st.pbt_args(audio_g, state)), ref)
        out, state = small_st.process_planar(xr, xi, state)
        torch.cuda.synchronize()
        d = max_diff((out["audio_l"], out["audio_r"], state.audio_tail, state.agc_env),
                     ref + (audio_g[:, -128:], env))
        say(f"check staged 8 ch x 8192, segment {seg}: max |kernel - plain| mix_demod "
            f"{d_a:.3e}, pbt {d_b:.3e}, the path over L, R, audio_tail, env {d:.3e} "
            f"(tolerance {TOL:g})")
        check(max(d_a, d_b, d) <= TOL, f"a staged kernel disagrees with its plain version: "
              f"{max(d_a, d_b, d):.3e} > {TOL:g}")
        err["mix_demod"] = max(err["mix_demod"], d_a, d)
        err["pbt"] = max(err["pbt"], d_b, d)
    cfg_am = ReceiverConfig(mode=DemodMode.AM, vfo_freq=7_060_000.0,
                            capture_center_freq=7_050_000.0, agc=AGCMode.OFF)
    freqs_am = [7_050_000.0 + 1_000.0 * k for k in range(N_AM)]
    for agc_mode in (AGCMode.MEDIUM, AGCMode.OFF):
        for nb in (False, True):
            kname = "sweep_chain_am_nb" if nb else "sweep_chain_am"
            small_am = FusedAMBank(cfg_am.with_(agc=agc_mode, noise_blanker=nb), freqs_am[:8])
            state = small_am.init_state()
            if nb:
                xr, xi, mean_mag = nb_scene(8, 8192, gen)
                state = state._replace(nb_avg=torch.full((8,), mean_mag, device="cuda"))
            for seg in range(2):
                if not nb:
                    xr, xi = noise((8, 8192), gen) + 0.2, noise((8, 8192), gen)
                    xr[:, 3000:3400] *= 30.0
                ref = sweep.sweep_am_chain_plain(*small_am.chain_args(xr, xi, state))
                out, state = small_am.process_planar(xr, xi, state)
                torch.cuda.synchronize()
                got = (out["audio_l"], out["audio_r"], state.audio_tail, state.agc_env,
                       state.am_dc) + ((state.nb_avg, state.nb_mask) if nb else ())
                d = max_diff(got, ref)
                say(f"check {kname} 8 ch x 8192 (AGC {agc_mode.value}"
                    f"{', impulse scene' if nb else ''}), segment {seg}: max |kernel - plain| "
                    f"over L, R, audio_tail, env, am_dc{', nb_avg, nb_mask' if nb else ''} = "
                    f"{d:.3e} (tolerance {TOL:g})")
                check(d <= TOL, f"{kname} disagrees with the plain version: {d:.3e} > {TOL:g}")
                if nb:
                    check(float(state.nb_mask.mean()) < 1.0,
                          "the impulse on the segment's last sample was not blanked")
                err[kname] = max(err[kname], d)

    mu = lms.lms_mu_from_strength(30)
    for mode in ("notch", "denoise"):
        state = lms.lms_nr_init(8, device="cuda")
        x_all = tone_scene(8, 2 * 8192, gen)
        for seg in range(2):   # first=True into segment 0: the quirk
            x = x_all[:, seg * 8192:(seg + 1) * 8192].contiguous()
            args = (x, state.weights, state.window, state.delay, state.first, mu, mode)
            ref = lms_bank.lms_nr_run_bank_plain(*args)
            got = lms_bank.lms_nr_run_bank(*args)
            torch.cuda.synchronize()
            d = max_diff(got, ref)
            say(f"check lms_nr ({mode}) 8 ch x 8192, segment {seg} (first="
                f"{bool(state.first.all())}): max |kernel - plain| over out, weights, "
                f"window, delay = {d:.3e} (tolerance {TOL_LMS:g})")
            check(d <= TOL_LMS, f"lms_nr disagrees with the plain version: {d:.3e} > {TOL_LMS:g}")
            err["lms_nr"] = max(err["lms_nr"], d)
            state = lms.LMSState(*got[1:], first=torch.zeros_like(state.first))

    state = small.init_state()
    for seg in range(2):
        xr, xi = noise((8, 8192), gen), noise((8, 8192), gen)
        xr[:, 3000:3400] *= 30.0
        args = small.chain_args(xr, xi, state)
        got = sweep.sweep_full_chain(*args, emit_r=False)
        ref = sweep.sweep_full_chain_plain(*args, emit_r=False)
        out, state = small.process_planar(xr, xi, state)
        torch.cuda.synchronize()
        check(got[1] is None and ref[1] is None, "emit_r=False returned an R")
        d = max_diff(got[:1] + got[2:], ref[:1] + ref[2:])
        same = bool(torch.equal(got[0], out["audio_l"]))
        say(f"check sweep_chain_ssb_mono 8 ch x 8192, segment {seg}: max |kernel - plain| over "
            f"L, audio_tail, env = {d:.3e} (tolerance {TOL:g}); R is None; L equal to "
            f"sweep_chain_ssb's: {same}")
        check(d <= TOL, f"sweep_chain_ssb_mono disagrees with the plain version: {d:.3e} > {TOL:g}")
        check(same, "sweep_chain_ssb_mono's L differs from sweep_chain_ssb's")
        err["sweep_chain_ssb_mono"] = max(err["sweep_chain_ssb_mono"], d)

    cfg4 = cfg.with_(nr=NRMode.SPEC2)   # bench_full.py config4_spec_nr_64ch
    for agc_mode in (AGCMode.MEDIUM, AGCMode.OFF):
        small_nr = FusedNRBank(cfg4.with_(agc=agc_mode, input_gain=0.7, iq_gain_balance=1.02),
                               freqs[:8])
        state = small_nr.init_state()
        for seg in range(2):
            xr, xi = noise((8, 8192), gen), noise((8, 8192), gen)
            xr[:, 3000:3400] *= 30.0
            args = small_nr.spec_args(xr, xi, state)
            ref = sweep_spec.sweep_spec_chain_plain(*args)
            near, nf = floor_margins(sweep_spec.lanes_args(*args), sweep)
            out, state = small_nr.process_planar(xr, xi, state)
            torch.cuda.synchronize()
            d_lr, n_near, n_moved, ok = spectral_diff((out["audio_l"], out["audio_r"]), ref[:2],
                                                      near, nf, small_nr.params.output_gain, TOL)
            d = max(d_lr, max_diff((state.audio_tail, state.agc_env, state.nfloor,
                                    state.spec_tail_l, state.spec_tail_r), ref[2:]))
            say(f"check sweep_spec_chain 8 ch x 8192 (AGC {agc_mode.value}, input gain 0.7, "
                f"balance 1.02), segment {seg}: max |kernel - plain| over L, R, audio_tail, env, "
                f"nfloor, spec_tail_l, spec_tail_r = {d:.3e} (tolerance {TOL:g}); frames with a "
                f"bin within {FLIP_MARGIN:g} of the floor {n_near}, of them over {TOL:g}: "
                f"{n_moved}, all within the flip bound: {ok}")
            check(d <= TOL and ok, f"sweep_spec_chain disagrees with the plain version: "
                  f"{d:.3e} > {TOL:g} or a frame outside its flip bound")
            err["sweep_spec_chain"] = max(err["sweep_spec_chain"], d)
    del small, small_nb, small_st, small_am, small_nr

    def drive(bank, xr, xi, state, label, channels=N_CHANNELS, seg_len=SEG_LEN):
        """SEGMENTS threaded segments with the launch counts set to 0 before and
        read after (and added to ``launches``); returns (the counts, state
        into segment 1, its output, the state out of it, the final state)."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        reset_counts()
        for seg in range(SEGMENTS):
            if seg == 1:
                state_1 = state
            out, state = bank.process_planar(xr, xi, state)
            if seg == 1:
                out_1, state_2 = out, state
        torch.cuda.synchronize()
        launched = counts()
        for k, v in launched.items():
            launches[k] += v
        say(f"{label}: {channels} ch x {seg_len} samples, {SEGMENTS} threaded segments "
            f"in {time.perf_counter() - t:.3f} s, kernel launches {launched}")
        for key in ("audio_l", "audio_r"):
            check(tuple(out[key].shape) == (channels, seg_len), f"{key} shape {tuple(out[key].shape)}")
            check(bool(torch.isfinite(out[key]).all()), f"{key} has non-finite values")
        return launched, state_1, out_1, state_2, state

    # 4. the main path at full width: 128 ch x 2^19, threaded segments
    bank = FusedSSBBank(cfg, freqs)
    xr, xi = noise((N_CHANNELS, SEG_LEN), gen), noise((N_CHANNELS, SEG_LEN), gen)
    launched, state_1, out_1, state_2, state = drive(bank, xr, xi, bank.init_state(), "main path")
    check(launched == only(sweep_chain_ssb=SEGMENTS), f"expected {SEGMENTS} sweep_chain_ssb launches and no "
          f"other, counted {launched}")
    ref = sweep.sweep_full_chain_plain(*bank.chain_args(xr, xi, state_1))
    d = max_diff((out_1["audio_l"], out_1["audio_r"], state_2.audio_tail, state_2.agc_env), ref)
    rms = float(out_1["audio_l"].square().mean().sqrt())
    say(f"check full width, segment 1: max |kernel - plain| = {d:.3e} "
        f"(tolerance {TOL:g}); output finite, rms(L) = {rms:.4f}")
    check(d <= TOL, f"sweep_chain_ssb disagrees at full width: {d:.3e} > {TOL:g}")
    err["sweep_chain_ssb"] = max(err["sweep_chain_ssb"], d)
    args = bank.chain_args(xr, xi, state_1)
    mono = sweep.sweep_full_chain(*args, emit_r=False)
    ref = sweep.sweep_full_chain_plain(*args, emit_r=False)
    torch.cuda.synchronize()
    d = max_diff(mono[:1] + mono[2:], ref[:1] + ref[2:])
    same = mono[1] is None and bool(torch.equal(mono[0], out_1["audio_l"]))
    say(f"check sweep_chain_ssb_mono full width, segment 1: max |kernel - plain| over L, "
        f"audio_tail, env = {d:.3e} (tolerance {TOL:g}); R None and L equal to the main "
        f"path's: {same}")
    check(d <= TOL, f"sweep_chain_ssb_mono disagrees at full width: {d:.3e} > {TOL:g}")
    check(same, "sweep_chain_ssb_mono's L differs from sweep_chain_ssb's at full width")
    err["sweep_chain_ssb_mono"] = max(err["sweep_chain_ssb_mono"], d)
    sweep_out_1 = out_1
    del ref, out_1, mono, args

    # 4b. the staged path at full width, on the same input
    bank_st = FusedSSBBank(cfg, freqs, backend="staged")
    launched, st_1, out_1, st_2, state_st = drive(bank_st, xr, xi, bank_st.init_state(),
                                                  "staged path")
    check(launched == only(mix_demod=SEGMENTS, pbt=SEGMENTS), f"expected {SEGMENTS} launches each of mix_demod "
          f"and pbt (2 per segment) and no other, counted {launched}")
    args = bank_st.mix_demod_args(xr, xi, st_1)
    audio = staged.fused_mix_filter_demod_plain(*args)
    d_a = max_diff([staged.fused_mix_filter_demod(*args)], [audio])
    audio_g, env = agc.agc_run(audio, bank_st.agc_params, st_1.agc_env)
    del audio
    ref = staged.pbt_filter_plain(*bank_st.pbt_args(audio_g, st_1))
    d_b = max_diff(staged.pbt_filter(*bank_st.pbt_args(audio_g, st_1)), ref)
    d = max_diff((out_1["audio_l"], out_1["audio_r"], st_2.audio_tail, st_2.agc_env),
                 ref + (audio_g[:, -128:], env))
    d_sw = max_diff((out_1["audio_l"], out_1["audio_r"]),
                    (sweep_out_1["audio_l"], sweep_out_1["audio_r"]))
    say(f"check staged full width, segment 1: max |kernel - plain| mix_demod {d_a:.3e}, "
        f"pbt {d_b:.3e}, the path {d:.3e} (tolerance {TOL:g}); max |staged - sweep| "
        f"over L, R = {d_sw:.3e} (tolerance {TOL_BACKENDS:g})")
    check(max(d_a, d_b, d) <= TOL, f"the staged path disagrees with its plain version at "
          f"full width: {max(d_a, d_b, d):.3e} > {TOL:g}")
    check(d_sw <= TOL_BACKENDS, f"staged and sweep backends disagree: {d_sw:.3e} > "
          f"{TOL_BACKENDS:g}")
    err["mix_demod"] = max(err["mix_demod"], d_a, d)
    err["pbt"] = max(err["pbt"], d_b, d)
    del ref, out_1, audio_g, sweep_out_1

    # 4c. the noise-blanker path at full width, on the impulse scene
    bank_nb = FusedSSBBank(cfg_nb, freqs)
    xr_nb, xi_nb, mean_mag = nb_scene(N_CHANNELS, SEG_LEN, gen)
    state_nb = bank_nb.init_state()._replace(
        nb_avg=torch.full((N_CHANNELS,), mean_mag, device="cuda"))
    launched, nb_1, out_1, nb_2, state_nb = drive(bank_nb, xr_nb, xi_nb, state_nb,
                                                  "noise-blanker path")
    check(launched == only(sweep_chain_ssb_nb=SEGMENTS), f"expected {SEGMENTS} sweep_chain_ssb_nb launches and "
          f"no other, counted {launched}")
    ref = sweep.sweep_full_chain_plain(*bank_nb.chain_args(xr_nb, xi_nb, nb_1))
    d = max_diff((out_1["audio_l"], out_1["audio_r"], nb_2.audio_tail, nb_2.agc_env,
                  nb_2.nb_avg, nb_2.nb_mask), ref)
    kept = float(nb_2.nb_mask.mean())
    say(f"check noise-blanker full width, segment 1: max |kernel - plain| over L, R, "
        f"audio_tail, env, nb_avg, nb_mask = {d:.3e} (tolerance {TOL:g}); last block "
        f"kept {kept:.4f}")
    check(d <= TOL, f"sweep_chain_ssb_nb disagrees at full width: {d:.3e} > {TOL:g}")
    check(kept < 1.0, "the impulse on the segment's last sample was not blanked")
    err["sweep_chain_ssb_nb"] = max(err["sweep_chain_ssb_nb"], d)
    del ref, out_1

    # 4d. the AM path at full width: bench_full.py config1 (64 ch at 1 kHz, AGC
    # off), without and with the blanker (on the impulse scene)
    bank_am = FusedAMBank(cfg_am, freqs_am)
    xr_am, xi_am = noise((N_AM, SEG_LEN), gen), noise((N_AM, SEG_LEN), gen)
    bank_am_nb = FusedAMBank(cfg_am.with_(noise_blanker=True), freqs_am)
    xr_amnb, xi_amnb, mean_mag = nb_scene(N_AM, SEG_LEN, gen)
    ends = {}   # path -> (bank, input, the state after its run)
    for kname, b, x_r, x_i, st0 in (
            ("sweep_chain_am", bank_am, xr_am, xi_am, bank_am.init_state()),
            ("sweep_chain_am_nb", bank_am_nb, xr_amnb, xi_amnb, bank_am_nb.init_state()._replace(
                nb_avg=torch.full((N_AM,), mean_mag, device="cuda")))):
        launched, s_1, out_1, s_2, s_end = drive(b, x_r, x_i, st0, f"AM path ({kname})",
                                                 channels=N_AM)
        check(launched == only(**{kname: SEGMENTS}), f"expected {SEGMENTS} {kname} launches "
              f"and no other, counted {launched}")
        ref = sweep.sweep_am_chain_plain(*b.chain_args(x_r, x_i, s_1))
        got = (out_1["audio_l"], out_1["audio_r"], s_2.audio_tail, s_2.agc_env, s_2.am_dc)
        nb = kname.endswith("_nb")
        d = max_diff(got + ((s_2.nb_avg, s_2.nb_mask) if nb else ()), ref)
        say(f"check {kname} full width, segment 1: max |kernel - plain| over L, R, audio_tail, "
            f"env, am_dc{', nb_avg, nb_mask' if nb else ''} = {d:.3e} (tolerance {TOL:g}); "
            f"rms(L) = {float(out_1['audio_l'].square().mean().sqrt()):.4e}")
        check(d <= TOL, f"{kname} disagrees at full width: {d:.3e} > {TOL:g}")
        if nb:
            check(float(s_2.nb_mask.mean()) < 1.0,
                  "the impulse on the segment's last sample was not blanked")
        err[kname] = max(err[kname], d)
        ends[kname] = (b, x_r, x_i, s_end)
        del ref, out_1, got

    # 4e. the reference chain at full width: bench_full.py config3 (CW_NARROW,
    # NR notch, AGC fast) and config7 (USB, DNR2), 128 ch, backend="batched";
    # the LMS stage's arguments in segment 1 are recorded, and the per-sample
    # plain LMS runs on their first LMS_PREFIX samples (LMS is causal)
    cfg3 = ReceiverConfig(mode=DemodMode.CW_NARROW, vfo_freq=14_050_000.0,
                          capture_center_freq=14_049_000.0, agc=AGCMode.FAST,
                          nr=NRMode.NOTCH)
    cfg7 = cfg.with_(nr=NRMode.DNR2)
    lms_args, lms_plain_prefix_ms = {}, {}
    recorded = []
    run_lms = lms_bank.lms_nr_run_bank

    def record(*args):
        out = run_lms(*args)
        recorded.append((args, out))
        return out

    freqs3 = [cfg3.capture_center_freq + 1_000.0 * k for k in range(N_CHANNELS)]
    for label, c_rb in (("config3 notch", cfg3), ("config7 DNR2", cfg7)):
        rb = ReceiverBank(c_rb, freqs3 if c_rb is cfg3 else freqs, backend="batched")
        recorded.clear()
        lms_bank.lms_nr_run_bank = record
        try:
            launched, _, out_1, _, state_rb = drive(rb, xr, xi, rb.init_state(),
                                                    f"reference chain ({label})")
        finally:
            lms_bank.lms_nr_run_bank = run_lms
        check(launched == only(lms_nr=SEGMENTS), f"expected {SEGMENTS} lms_nr launches (1 "
              f"per segment) and no other, counted {launched}")
        check(len(recorded) == SEGMENTS, f"expected {SEGMENTS} calls of "
              f"lms_bank.lms_nr_run_bank through ops/lms.lms_nr_run, recorded "
              f"{len(recorded)}")
        (x, w, win, dl, first, mu_rb, mode), got = recorded[1]
        lms_args[label] = (x, w, win, dl, first, mu_rb, mode)
        x_pre = x[:, :LMS_PREFIX].contiguous()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        ref = lms_bank.lms_nr_run_bank_plain(x_pre, w, win, dl, first, mu_rb, mode)
        t1.record()
        t1.synchronize()
        lms_plain_prefix_ms[label] = t0.elapsed_time(t1)
        d = max_diff([got[0][:, :LMS_PREFIX]], ref[:1])
        say(f"check lms_nr ({mode}) full width, segment 1: max |kernel - plain| over the "
            f"first {LMS_PREFIX} outputs = {d:.3e} (tolerance {TOL_LMS:g}); "
            f"rms(L) = {float(out_1['audio_l'].square().mean().sqrt()):.4e}")
        check(d <= TOL_LMS, f"lms_nr disagrees at full width: {d:.3e} > {TOL_LMS:g}")
        err["lms_nr"] = max(err["lms_nr"], d)
        ends[label] = (rb, xr, xi, state_rb)
        del out_1, ref, got, recorded[:]

    # 4g. the NR bank at full width: bench_full.py config4 (USB, AGC medium,
    # SPEC2, 64 ch at 1 kHz, the main path's noise) folded on K4, staged, and
    # ReceiverBank's plain spectral stage (no kernel); config7 (DNR2) and
    # config3 (notch), 128 ch, staged (their folded route is the lanes kernel)
    freqs4 = freqs[:N_SPEC]
    xr4, xi4 = xr[:N_SPEC], xi[:N_SPEC]
    bank4 = FusedNRBank(cfg4, freqs4)
    launched, s4_1, out_1, s4_2, s4_end = drive(bank4, xr4, xi4, bank4.init_state(),
                                                "NR bank config4 fold=True", channels=N_SPEC)
    check(launched == only(sweep_spec_chain=SEGMENTS), f"expected {SEGMENTS} sweep_spec_chain "
          f"launches and no other, counted {launched}")
    args = bank4.spec_args(xr4, xi4, s4_1)
    ref = sweep_spec.sweep_spec_chain_plain(*args)
    near, nf = floor_margins(sweep_spec.lanes_args(*args), sweep)
    d_lr, n_near, n_moved, ok = spectral_diff((out_1["audio_l"], out_1["audio_r"]), ref[:2],
                                              near, nf, bank4.params.output_gain, TOL)
    d = max(d_lr, max_diff((s4_2.audio_tail, s4_2.agc_env, s4_2.nfloor, s4_2.spec_tail_l,
                            s4_2.spec_tail_r), ref[2:]))
    say(f"check sweep_spec_chain full width, segment 1: max |kernel - plain| over L, R, "
        f"audio_tail, env, nfloor, spec_tail_l, spec_tail_r = {d:.3e} (tolerance {TOL:g}) in "
        f"the {near.numel() - n_near} of {near.numel()} frames with no bin within "
        f"{FLIP_MARGIN:g} of the floor; the other {n_near}: {n_moved} over {TOL:g}, all within "
        f"the flip bound: {ok}; rms(L) = {float(out_1['audio_l'].square().mean().sqrt()):.4e}, "
        f"nfloor {float(s4_2.nfloor.min()):.4e}..{float(s4_2.nfloor.max()):.4e}")
    check(d <= TOL and ok, f"sweep_spec_chain disagrees at full width: {d:.3e} > {TOL:g} or "
          f"a frame outside its flip bound")
    del args, near, nf
    err["sweep_spec_chain"] = max(err["sweep_spec_chain"], d)
    ends["config4 fold=True"] = (bank4, xr4, xi4, s4_end)
    del ref, out_1

    cfg3_bank = FusedNRBank(cfg3, freqs3, fold=False)
    for label, b, x_r, x_i, expect in (
            ("config4 fold=False", FusedNRBank(cfg4, freqs4, fold=False), xr4, xi4,
             only(sweep_chain_ssb=SEGMENTS)),
            ("ReceiverBank config4 SPEC2", ReceiverBank(cfg4, freqs4), xr4, xi4, only()),
            ("config7 DNR2 fold=False", FusedNRBank(cfg7, freqs, fold=False), xr, xi,
             only(sweep_chain_ssb_mono=SEGMENTS, lms_nr=SEGMENTS)),
            ("config3 notch fold=False", cfg3_bank, xr, xi,
             only(mix_demod=SEGMENTS, lms_nr=SEGMENTS, pbt=SEGMENTS))):
        launched, _, _, _, s_end = drive(b, x_r, x_i, b.init_state(), f"NR path {label}",
                                         channels=x_r.shape[0])
        check(launched == expect, f"{label}: expected the launches {expect}, counted {launched}")
        ends[label] = (b, x_r, x_i, s_end)

    # 4f. cross-path parity: each fused bank against the port's ReceiverBank
    # on the same input, two threaded segments (docs/CHIP_PARITY.md); the
    # NR banks' noise floors too, relative (tests/test_fused_bank.py:196).
    # The spectral routes are compared frame by frame (spectral_diff), with
    # the bins near the floor found by the plain K4 on the same segments
    st, spec_near = bank4.init_state(), []
    for _ in range(2):
        spec_near.append(floor_margins(sweep_spec.lanes_args(*bank4.spec_args(xr4, xi4, st)),
                                       sweep))
        _, st = bank4.process_planar(xr4, xi4, st)
    parity = {}
    for label, fused_bank, ref_bank, x_r, x_i, near in (
            ("FusedSSBBank vs ReceiverBank(USB)", bank,
             ReceiverBank(cfg, freqs), xr, xi, None),
            ("FusedAMBank vs ReceiverBank(AM)", bank_am,
             ReceiverBank(cfg_am, freqs_am), xr_am, xi_am, None),
            ("FusedNRBank(fold=True) vs ReceiverBank(SPEC2), config4", bank4,
             ReceiverBank(cfg4, freqs4), xr4, xi4, spec_near),
            ("FusedNRBank(fold=False) vs ReceiverBank(SPEC2), config4",
             ends["config4 fold=False"][0], ReceiverBank(cfg4, freqs4), xr4, xi4, spec_near),
            ("FusedNRBank(fold=False) vs ReceiverBank(DNR2), config7",
             ends["config7 DNR2 fold=False"][0], ReceiverBank(cfg7, freqs), xr, xi, None),
            ("FusedNRBank(fold=False) vs ReceiverBank(NOTCH), config3", cfg3_bank,
             ReceiverBank(cfg3, freqs3), xr, xi, None)):
        st_f, st_r, worst, worst_nf = fused_bank.init_state(), ref_bank.init_state(), 0.0, 0.0
        n_near = n_moved = 0
        ok = True
        for seg in range(2):
            out_f, st_f = fused_bank.process_planar(x_r, x_i, st_f)
            out_r, st_r = ref_bank.process_planar(x_r, x_i, st_r)
            got, want = (out_f["audio_l"], out_f["audio_r"]), (out_r["audio_l"], out_r["audio_r"])
            if near is None:
                worst = max(worst, max_diff(got, want))
            else:
                d, k, moved, seg_ok = spectral_diff(got, want, *near[seg],
                                                    ref_bank.params.output_gain, TOL_PARITY)
                worst, n_near, n_moved, ok = max(worst, d), n_near + k, n_moved + moved, ok and seg_ok
            if hasattr(st_f, "nfloor"):
                worst_nf = max(worst_nf, float(((st_f.nfloor - st_r.nfloor).abs()
                                                / st_r.nfloor.abs().clamp(min=1e-6)).max()))
        parity[label] = worst
        say(f"parity {label}, {x_r.shape[0]} ch x {SEG_LEN}, 2 threaded segments: max abs "
            f"diff over L, R = {worst:.3e} (bound {TOL_PARITY:g})"
            + ("" if near is None else f" in the frames with no bin within {FLIP_MARGIN:g} of "
               f"the floor; the other {n_near}: {n_moved} over {TOL_PARITY:g}, all within the "
               f"flip bound: {ok}")
            + (f"; nfloor relative {worst_nf:.3e} (bound 1e-3)" if hasattr(st_f, "nfloor")
               else ""))
        check(worst <= TOL_PARITY and ok, f"{label}: {worst:.3e} > {TOL_PARITY:g} or a frame "
              f"outside its flip bound")
        check(worst_nf <= 1e-3, f"{label}: nfloor relative {worst_nf:.3e} > 1e-3")
        del out_f, out_r, got, want
    del spec_near

    # 4h. SAM at full width on locked-carrier scenes: bench_full.py config6
    # (128 ch at 1 kHz, AGC medium; staged K5 + pbt, folded K6, K6 + blanker)
    # and config10 (1,024 ch, 2^17-sample segments; K7, K7 + blanker). The
    # plain PLL is one host-bound step per sample, so each kernel is held to
    # it on a SAM_PREFIX-sample prefix of the full width: threaded as two
    # segments (every carry crosses a boundary), and the full run's segment 1
    # on its first SAM_PREFIX samples (the chain is causal), timed
    cfg_sam = ReceiverConfig(mode=DemodMode.SAM, vfo_freq=7_060_000.0,
                             capture_center_freq=7_050_000.0, agc=AGCMode.MEDIUM)
    cfg_sam_nb = cfg_sam.with_(noise_blanker=True)
    freqs10 = [cfg_sam.capture_center_freq + 1_000.0 * k for k in range(N_SAM_WIDE)]
    nco10 = [f - cfg_sam.tuning_offset - cfg_sam.capture_center_freq for f in freqs10]
    sam_plain_prefix_ms, sam_ends, half = {}, {}, SAM_PREFIX // 2

    def timed(fn):
        """(fn(), its time in ms by CUDA events)."""
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        out = fn()
        t1.record()
        t1.synchronize()
        return out, t0.elapsed_time(t1)

    # config6 staged: K5 (recorded through ops/sam.sam_pll_run, as the LMS
    # stage is above) and pbt
    c6 = N_SAM
    xr6, xi6, _ = locked_scene(c6, SEG_LEN, gen, nco10[:c6])
    bank6s = FusedSAMBank(cfg_sam, freqs10[:c6], fold=False)
    run_pll, pll_calls = sam.sam_pll_run, []

    def record_pll(*args):
        out = run_pll(*args)
        pll_calls.append((args, out))
        return out

    sam.sam_pll_run = record_pll
    try:
        launched, _, out_1, _, s6s_end = drive(bank6s, xr6, xi6, bank6s.init_state(),
                                               "SAM config6 fold=False", channels=c6)
    finally:
        sam.sam_pll_run = run_pll
    check(launched == only(sam_pll=SEGMENTS, pbt=SEGMENTS), f"expected {SEGMENTS} launches "
          f"each of sam_pll and pbt (2 per segment) and no other, counted {launched}")
    check(len(pll_calls) == SEGMENTS, f"expected {SEGMENTS} calls of sam.sam_pll_run, "
          f"recorded {len(pll_calls)}")
    (zr, zi, ph0, fr0, bw, fs, chunk), got = pll_calls[1]
    ref, sam_plain_prefix_ms["sam_pll"] = timed(lambda: sam.sam_pll_run_plain(
        zr[:, :SAM_PREFIX].contiguous(), zi[:, :SAM_PREFIX].contiguous(), ph0, fr0, bw, fs,
        chunk))
    d_full = max_diff([got[0][:, :SAM_PREFIX]], ref[:1])
    d_two, ph, fr = 0.0, ph0, fr0
    for h in range(2):   # two threaded segments of the prefix
        args = (zr[:, h * half:(h + 1) * half].contiguous(),
                zi[:, h * half:(h + 1) * half].contiguous(), ph, fr, bw, fs, chunk)
        k_out, p_out = sam.sam_pll_run(*args), sam.sam_pll_run_plain(*args)
        d_two = max(d_two, max_diff((k_out[0], k_out[2]), (p_out[0], p_out[2])),
                    phase_diff(k_out[1], p_out[1]))
        ph, fr = k_out[1], k_out[2]
    torch.cuda.synchronize()
    d = max(d_full, d_two)
    say(f"check sam_pll full width ({c6} ch), segment 1: max |kernel - plain| over vr on its "
        f"first {SAM_PREFIX} samples = {d_full:.3e}; over vr, phase (wrap-aware), freq, "
        f"{SAM_PREFIX} samples as two threaded segments = {d_two:.3e} (tolerance {TOL:g}); "
        f"rms(L) = {float(out_1['audio_l'].square().mean().sqrt()):.4e}")
    check(d <= TOL, f"sam_pll disagrees with the plain version: {d:.3e} > {TOL:g}")
    err["sam_pll"] = d
    pll_args = pll_calls[1][0]
    sam_ends["config6 fold=False"] = (bank6s, xr6, xi6, s6s_end)
    del pll_calls, zr, zi, got, ref, out_1

    def sam_kernel_checks(kname, bank, xr, xi, state0, label, seg_len):
        """Drive the folded route (launch counts: 1 of kname per segment and no
        other), then hold its kernel to the plain chain on the prefix: two
        threaded segments of half the prefix through the bank, and the full
        run's segment 1 on its first SAM_PREFIX samples, on the full run's
        re-seed schedule. Returns the state after the drive."""
        c = xr.shape[0]
        plain = sam_wide.sweep_sam_wide_plain if bank.route == "wide" else \
            sweep.sweep_sam_chain_plain
        nb = kname.endswith("_nb")
        st = state0
        d_two = 0.0
        for h in range(2):
            x_r = xr[:, h * half:(h + 1) * half].contiguous()
            x_i = xi[:, h * half:(h + 1) * half].contiguous()
            ref = plain(*bank.chain_args(x_r, x_i, st))
            out, st = bank.process_planar(x_r, x_i, st)
            torch.cuda.synchronize()
            got = (out["audio_l"], out["audio_r"], st.audio_tail, st.agc_env, st.sam_dc,
                   st.sam_freq[:c]) + ((st.nb_avg, st.nb_mask) if nb else ())
            want = ref[:5] + (ref[5][1],) + ref[6:]
            d_two = max(d_two, max_diff(got, want), phase_diff(st.sam_phase[:c], ref[5][0]))
        launched, s_1, out_1, _, s_end = drive(bank, xr, xi, state0, label, channels=c,
                                               seg_len=seg_len)
        check(launched == only(**{kname: SEGMENTS}), f"expected {SEGMENTS} {kname} launches "
              f"and no other, counted {launched}")
        ref, sam_plain_prefix_ms[kname] = timed(lambda: plain(*bank.chain_args(
            xr[:, :SAM_PREFIX].contiguous(), xi[:, :SAM_PREFIX].contiguous(), s_1,
            reseed=bank.reseed_schedule(seg_len))))
        d_full = max_diff((out_1["audio_l"][:, :SAM_PREFIX], out_1["audio_r"][:, :SAM_PREFIX]),
                          ref[:2])
        d = max(d_two, d_full)
        say(f"check {kname} full width ({c} ch), segment 1: max |kernel - plain| over L, R on "
            f"the first {SAM_PREFIX} samples = {d_full:.3e}; over L, R, audio_tail, env, "
            f"sam_dc, sam_phase (wrap-aware), sam_freq{', nb_avg, nb_mask' if nb else ''}, "
            f"{SAM_PREFIX} samples as two threaded segments = {d_two:.3e} (tolerance {TOL:g}); "
            f"rms(L) = {float(out_1['audio_l'].square().mean().sqrt()):.4e}")
        check(d <= TOL, f"{kname} disagrees with the plain version: {d:.3e} > {TOL:g}")
        if nb:
            check(float(s_end.nb_mask[:, -1].max()) == 0.0,
                  "the impulse on the segment's last sample was not blanked")
        err[kname] = max(err[kname], d)
        return s_end

    bank6 = FusedSAMBank(cfg_sam, freqs10[:c6])
    check(bank6.route == "lanes", f"config6 folded route {bank6.route}")
    sam_ends["sweep_chain_sam"] = (bank6, xr6, xi6, sam_kernel_checks(
        "sweep_chain_sam", bank6, xr6, xi6, bank6.init_state(), "SAM config6 fold=True",
        SEG_LEN))
    xr6nb, xi6nb, mean6 = locked_scene(c6, SEG_LEN, gen, nco10[:c6], impulses=True)
    bank6nb = FusedSAMBank(cfg_sam_nb, freqs10[:c6])
    st0 = bank6nb.init_state()._replace(nb_avg=torch.full((c6,), mean6, device="cuda"))
    sam_ends["sweep_chain_sam_nb"] = (bank6nb, xr6nb, xi6nb, sam_kernel_checks(
        "sweep_chain_sam_nb", bank6nb, xr6nb, xi6nb, st0, "SAM config6 fold=True + blanker",
        SEG_LEN))

    xr10, xi10, _ = locked_scene(N_SAM_WIDE, SEG_WIDE, gen, nco10)
    bank10 = FusedSAMBank(cfg_sam, freqs10)
    check((bank10.route, bank10.groups) == ("wide", 8), f"config10 route {bank10.route} "
          f"G={bank10.groups}")
    sam_ends["sam_wide"] = (bank10, xr10, xi10, sam_kernel_checks(
        "sam_wide", bank10, xr10, xi10, bank10.init_state(), "SAM config10", SEG_WIDE))
    xr10nb, xi10nb, mean10 = locked_scene(N_SAM_WIDE, SEG_WIDE, gen, nco10, impulses=True)
    bank10nb = FusedSAMBank(cfg_sam_nb, freqs10)
    st0 = bank10nb.init_state()._replace(nb_avg=torch.full((N_SAM_WIDE,), mean10, device="cuda"))
    sam_ends["sam_wide_nb"] = (bank10nb, xr10nb, xi10nb, sam_kernel_checks(
        "sam_wide_nb", bank10nb, xr10nb, xi10nb, st0, "SAM config10 + blanker", SEG_WIDE))

    # K7 against K6 (wide_groups=1, one channel a block) at config10, two
    # threaded full segments: their re-seed periods (256, 1,024) differ
    bank10k6 = FusedSAMBank(cfg_sam, freqs10, wide_groups=1)
    s_w, s_n, worst, worst_ph = bank10.init_state(), bank10k6.init_state(), 0.0, 0.0
    for _ in range(2):
        o_w, s_w = bank10.process_planar(xr10, xi10, s_w)
        o_n, s_n = bank10k6.process_planar(xr10, xi10, s_n)
        worst = max(worst, max_diff((o_w["audio_l"], o_w["audio_r"]),
                                    (o_n["audio_l"], o_n["audio_r"])))
        worst_ph = max(worst_ph, phase_diff(s_w.sam_phase, s_n.sam_phase))
    say(f"parity sam_wide (K7) vs sweep_chain_sam (K6, wide_groups=1), {N_SAM_WIDE} ch x "
        f"{SEG_WIDE}, 2 threaded segments: max abs diff over L, R = {worst:.3e}, PLL phase "
        f"{worst_ph:.3e} (bound {TOL_PARITY:g})")
    check(max(worst, worst_ph) <= TOL_PARITY, f"K7 and K6 disagree: {max(worst, worst_ph):.3e} "
          f"> {TOL_PARITY:g}")
    del o_w, o_n, s_w, s_n, bank10k6

    # each SAM route against ReceiverBank(SAM), the exact PLL (plain PyTorch,
    # one step per sample), on the prefix as two threaded segments
    for label, key in (("FusedSAMBank(fold=False) config6", "config6 fold=False"),
                       ("FusedSAMBank config6 (K6)", "sweep_chain_sam"),
                       ("FusedSAMBank config6 + blanker (K6)", "sweep_chain_sam_nb"),
                       ("FusedSAMBank config10 (K7)", "sam_wide"),
                       ("FusedSAMBank config10 + blanker (K7)", "sam_wide_nb")):
        b, x_r, x_i, _ = sam_ends[key]
        c = x_r.shape[0]
        rb = ReceiverBank(b.config, freqs10[:c])
        st_f, st_r = b.init_state(), rb.init_state()
        if b.config.noise_blanker:
            warm = float(torch.hypot(x_r, x_i).mean())
            st_f = st_f._replace(nb_avg=torch.full((c,), warm, device="cuda"))
            st_r = st_r._replace(nb_avg=torch.full((c,), warm, device="cuda"))
        worst = worst_ph = 0.0
        for h in range(2):
            xs = (x_r[:, h * half:(h + 1) * half].contiguous(),
                  x_i[:, h * half:(h + 1) * half].contiguous())
            out_f, st_f = b.process_planar(*xs, st_f)
            out_r, st_r = rb.process_planar(*xs, st_r)
            worst = max(worst, max_diff((out_f["audio_l"], out_f["audio_r"]),
                                        (out_r["audio_l"], out_r["audio_r"])))
            worst_ph = max(worst_ph, phase_diff(st_f.sam_phase[:c], st_r.sam.phase))
        say(f"parity {label} vs ReceiverBank(SAM), {c} ch x {SAM_PREFIX} as 2 threaded "
            f"segments: max abs diff over L, R = {worst:.3e}, PLL phase {worst_ph:.3e} "
            f"(bound {TOL_PARITY:g})")
        check(max(worst, worst_ph) <= TOL_PARITY, f"{label}: {max(worst, worst_ph):.3e} > "
              f"{TOL_PARITY:g}")
    del out_f, out_r

    # 4i. the folded NR banks on the lanes kernel's NR instantiations (K6):
    # bench_full.py config3 (CW_NARROW + notch), config7 (USB + DNR2) and
    # config8 (AM + DNR2) at full width, 128 ch x 2^19, SEGMENTS checked and
    # REPS timed; the other fourteen routes at 128 ch x SEG_NR (a cut of the
    # segment, PERF.md section 4), two threaded segments. The plain LMS and
    # PLL are host-bound per-sample loops, so each kernel is held to its plain
    # chain on a prefix (LMS_PREFIX samples, SAM_PREFIX with SAM; the whole
    # segment for AM and SSB spectral): as two threaded segments of half the
    # prefix, every carry compared, and as the full run's segment 1 on its
    # first samples (the chain is causal). Spectral NR is compared frame by
    # frame (spectral_diff). Each bank against the port's ReceiverBank (SAM on
    # the prefix, the exact PLL being per-sample plain PyTorch)
    cfg8 = cfg_am.with_(agc=AGCMode.MEDIUM, nr=NRMode.DNR2)
    freqs_c = freqs10[:N_CHANNELS]   # 7.05 MHz + k kHz, the AM and SAM routes' channels
    nr_ends, nr_plain_prefix = {}, {}

    def lanes_diff(out, st, ref, c, out_gain, near=None):
        """Max |kernel - plain| over a segment's audio (frame by frame for
        spectral NR, with near = floor_margins) and, with st, every carry the
        plain version returns (the PLL phase wrap-aware); and whether every
        frame is within its flip bound."""
        got = [out["audio_l"]] + ([out["audio_r"]] if ref.audio_r is not None else [])
        want = [ref.audio_l] + ([ref.audio_r] if ref.audio_r is not None else [])
        ok = True
        if near is None:
            d = max_diff(got, want)
        else:
            d, _, _, ok = spectral_diff(got, want, *near, out_gain, TOL)
        if st is None:
            return d, ok
        pairs = [(st.audio_tail, ref.audio_tail), (st.agc_env, ref.agc_env)]
        pairs += [(st.dc, ref.dc)] if ref.dc is not None else []
        pairs += [(st.pll[1, :c], ref.pll[1])] if ref.pll is not None else []
        pairs += [(getattr(st, k)[:c], getattr(ref, k)) for k in (
            "lms_weights", "lms_window", "lms_delay") if getattr(ref, k) is not None]
        pairs += [(getattr(st, k), getattr(ref, k)) for k in (
            "nfloor", "spec_tail_l", "spec_tail_r", "nb_avg", "nb_mask")
            if getattr(ref, k) is not None]
        d = max(d, max_diff(*zip(*pairs)))
        if ref.pll is not None:
            d = max(d, phase_diff(st.pll[0, :c], ref.pll[0]))
        return d, ok

    def nr_route_checks(bank, xr, xi, state0, label, seg_len):
        """Drive the route (launch counts: 1 of its kernel per segment and no
        other), then hold the kernel to the plain chain on the prefix, and the
        bank to ReceiverBank. Returns the state after the drive."""
        kname, c = bank.kernel, xr.shape[0]
        spectral = bank.nr == "spectral"
        prefix = SAM_PREFIX if bank.demod == "sam" else seg_len if spectral else LMS_PREFIX
        tol = TOL if spectral else TOL_LMS
        pre = prefix // 2
        st, d_two, ok = state0, 0.0, True
        for h in range(2):
            x_r, x_i = xr[:, h * pre:(h + 1) * pre].contiguous(), xi[:, h * pre:(h + 1) * pre].contiguous()
            args = bank.lanes_args(x_r, x_i, st)
            ref = lanes.sweep_lanes_chain_plain(*args)
            near = floor_margins(args, sweep) if spectral else None
            out, st = bank.process_planar(x_r, x_i, st)
            torch.cuda.synchronize()
            d, seg_ok = lanes_diff(out, st, ref, c, bank.params.output_gain, near)
            d_two, ok = max(d_two, d), ok and seg_ok
        launched, s_1, out_1, _, s_end = drive(bank, xr, xi, state0, label, channels=c,
                                               seg_len=seg_len)
        check(launched == only(**{kname: SEGMENTS}), f"expected {SEGMENTS} {kname} launches "
              f"and no other, counted {launched}")
        args = bank.lanes_args(xr[:, :prefix].contiguous(), xi[:, :prefix].contiguous(), s_1)
        ref, ms = timed(lambda: lanes.sweep_lanes_chain_plain(*args))
        nr_plain_prefix[kname] = (ms, prefix)
        near = floor_margins(args, sweep) if spectral else None
        d_full, seg_ok = lanes_diff({k: v[:, :prefix] for k, v in out_1.items()}, None, ref, c,
                                    bank.params.output_gain, near)
        ok = ok and seg_ok
        same_r = (out_1["audio_r"] is out_1["audio_l"]) == (bank.nr == "denoise")
        say(f"check {kname} full width ({c} ch x {seg_len}), segment 1: max |kernel - plain| "
            f"over the audio on the first {prefix} samples = {d_full:.3e}; over the audio and "
            f"every carry, {prefix} samples as two threaded segments = {d_two:.3e} (tolerance "
            f"{tol:g}{', frame by frame, all within the flip bound: ' + str(ok) if spectral else ''}"
            f"); R {'is L' if bank.nr == 'denoise' else 'its own'}: {same_r}; rms(L) = "
            f"{float(out_1['audio_l'].square().mean().sqrt()):.4e}")
        check(max(d_full, d_two) <= tol and ok and same_r, f"{kname} disagrees with the plain "
              f"version: {max(d_full, d_two):.3e} > {tol:g}, a frame outside its flip bound, "
              f"or R")
        if bank.config.noise_blanker:
            check(float(s_end.nb_mask[:, -1].max()) == 0.0,
                  "the impulse on the segment's last sample was not blanked")
        err[kname] = max(err[kname], d_full, d_two)
        # the bank against ReceiverBank: two full segments, SAM the prefix as two
        rb = ReceiverBank(bank.config, bank_freqs[kname])
        st_f, st_r = state0, rb.init_state()._replace(nb_avg=state0.nb_avg.clone())
        span = pre if bank.demod == "sam" else seg_len
        worst, ok = 0.0, True
        for h in range(2):
            x_r = xr[:, h * span:(h + 1) * span].contiguous() if span < seg_len else xr
            x_i = xi[:, h * span:(h + 1) * span].contiguous() if span < seg_len else xi
            near = floor_margins(bank.lanes_args(x_r, x_i, st_f), sweep) if spectral else None
            out_f, st_f = bank.process_planar(x_r, x_i, st_f)
            out_r, st_r = rb.process_planar(x_r, x_i, st_r)
            got, want = (out_f["audio_l"], out_f["audio_r"]), (out_r["audio_l"], out_r["audio_r"])
            if near is None:
                worst = max(worst, max_diff(got, want))
            else:
                d, _, _, seg_ok = spectral_diff(got, want, *near, bank.params.output_gain,
                                                TOL_PARITY)
                worst, ok = max(worst, d), ok and seg_ok
        parity[f"{kname} vs ReceiverBank"] = worst
        say(f"parity FusedNRBank {label} ({kname}) vs ReceiverBank, {c} ch x "
            f"{span if span < seg_len else seg_len}, 2 threaded segments: max abs diff over "
            f"L, R = {worst:.3e} (bound {TOL_PARITY:g}{', frame by frame' if spectral else ''})")
        check(worst <= TOL_PARITY and ok, f"{kname}: {worst:.3e} > {TOL_PARITY:g}")
        nr_ends[kname] = (bank, xr, xi, s_end)
        return s_end

    # the full-width configurations on the main path's noise (config3, config7)
    # and the AM path's kind (config8)
    bank_freqs = {}
    xr8, xi8 = noise((N_CHANNELS, SEG_LEN), gen), noise((N_CHANNELS, SEG_LEN), gen)
    for label, c_nr, fq, x_r, x_i in (("config3 notch", cfg3, freqs3, xr, xi),
                                      ("config7 DNR2", cfg7, freqs, xr, xi),
                                      ("config8 AM + DNR2", cfg8, freqs_c, xr8, xi8)):
        b = FusedNRBank(c_nr, fq)
        bank_freqs[b.kernel] = fq
        nr_route_checks(b, x_r, x_i, b.init_state(), f"{label} fold=True", SEG_LEN)

    # folded against staged over two full segments: the same recurrences
    for label, kname, staged_label in (("config3 notch", "lanes_ssb_notch", "config3 notch fold=False"),
                                       ("config7 DNR2", "lanes_ssb_denoise", "config7 DNR2 fold=False")):
        b_f, b_s = nr_ends[kname][0], ends[staged_label][0]
        s_f, s_s, worst = b_f.init_state(), b_s.init_state(), 0.0
        for _ in range(2):
            o_f, s_f = b_f.process_planar(xr, xi, s_f)
            o_s, s_s = b_s.process_planar(xr, xi, s_s)
            worst = max(worst, max_diff((o_f["audio_l"], o_f["audio_r"]),
                                        (o_s["audio_l"], o_s["audio_r"])))
        say(f"parity {label} fold=True ({kname}) vs fold=False, {N_CHANNELS} ch x {SEG_LEN}, "
            f"2 threaded segments: max abs diff over L, R = {worst:.3e} (bound {TOL_BACKENDS:g})")
        check(worst <= TOL_BACKENDS, f"{label}: folded and staged disagree: {worst:.3e}")
        del o_f, o_s

    # the other fourteen routes at 128 ch x SEG_NR: the blanker on the decisive
    # impulse scene, SAM on locked carriers, AM and SSB on noise
    xr_nrb, xi_nrb, mean_nrb = nb_scene(N_CHANNELS, SEG_NR, gen)
    xr_s, xi_s, _ = locked_scene(N_CHANNELS, SEG_NR, gen, nco10[:N_CHANNELS])
    xr_snb, xi_snb, mean_snb = locked_scene(N_CHANNELS, SEG_NR, gen, nco10[:N_CHANNELS],
                                            impulses=True)
    xr_n, xi_n = xr8[:, :SEG_NR].contiguous(), xi8[:, :SEG_NR].contiguous()
    short = [(cfg7.with_(nr=NRMode.DNR2), freqs), (cfg3, freqs3), (cfg.with_(nr=NRMode.SPEC2), freqs)]
    short = [(c.with_(noise_blanker=True), fq) for c, fq in short]
    for mode_cfg in (cfg8.with_(mode=DemodMode.AM), cfg8.with_(mode=DemodMode.SAM)):
        for nr_mode in (NRMode.DNR2, NRMode.NOTCH, NRMode.SPEC2):
            for nb in (False, True):
                short.append((mode_cfg.with_(nr=nr_mode, noise_blanker=nb), freqs_c))
    for c_nr, fq in short:
        b = FusedNRBank(c_nr, fq)
        if b.kernel in nr_ends:
            continue
        bank_freqs[b.kernel] = fq
        nb = c_nr.noise_blanker
        if b.demod == "sam":
            x_r, x_i, mean = (xr_snb, xi_snb, mean_snb) if nb else (xr_s, xi_s, None)
        else:
            x_r, x_i, mean = (xr_nrb, xi_nrb, mean_nrb) if nb else (xr_n, xi_n, None)
        st0 = b.init_state()
        if nb:
            st0 = st0._replace(nb_avg=torch.full((N_CHANNELS,), mean, device="cuda"))
        nr_route_checks(b, x_r, x_i, st0, f"{c_nr.mode.name} + {c_nr.nr.name}"
                        f"{' + blanker' if nb else ''} fold=True", SEG_NR)
    check(sorted(nr_ends) == sorted(lanes.KERNELS), f"routes driven {sorted(nr_ends)}")

    # 5. timing (CUDA events, after warm-up)
    samples = N_CHANNELS * SEG_LEN
    rows = samples // 128
    w_ssb, w_pbt = bank.params.w_ssb, bank.params.w_pbt
    f1 = torch.randn((rows, 512), generator=gen, device="cuda")
    f2 = torch.randn((rows, 256), generator=gen, device="cuda")
    lib1_ms = time_ms(lambda: torch.matmul(f1, w_ssb), REPS)
    lib2_ms = time_ms(lambda: torch.matmul(f2, w_pbt), REPS)
    library_ms = time_ms(lambda: (torch.matmul(f1, w_ssb), torch.matmul(f2, w_pbt)), REPS)
    w_pbt_l = w_pbt[:, :128].contiguous()   # the L half of PBT: all that emit_r=False needs
    library_mono_ms = time_ms(lambda: (torch.matmul(f1, w_ssb), torch.matmul(f2, w_pbt_l)), REPS)
    del f1, f2, w_pbt_l
    ops1, ops2 = rows * 2 * 512 * 128, rows * 2 * 256 * 256
    words_tails = N_CHANNELS * (2 * 8 + 4 * 128 * 4 + 2 * 4)
    w_bytes = 4 * (512 * 128 + 256 * 256)
    timing = {}

    args = bank.chain_args(xr, xi, state)
    b_ms, b_by = bound(ops1 + ops2, 4 * samples * 4 + w_bytes + words_tails)
    timing["sweep_chain_ssb"] = dict(
        ms=time_ms(lambda: sweep.sweep_full_chain(*args), REPS),
        plain_ms=time_ms(lambda: sweep.sweep_full_chain_plain(*args), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=library_ms, flops=ops1 + ops2,
        samples=samples)
    seg_ms = time_ms(lambda: bank.process_planar(xr, xi, state), REPS)
    # without R the function needs only L's half of the PBT product
    b_ms, b_by = bound(ops1 + ops2 // 2, 3 * samples * 4 + w_bytes + words_tails)
    timing["sweep_chain_ssb_mono"] = dict(
        ms=time_ms(lambda: sweep.sweep_full_chain(*args, emit_r=False), REPS),
        plain_ms=time_ms(lambda: sweep.sweep_full_chain_plain(*args, emit_r=False), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=library_mono_ms, flops=ops1 + ops2 // 2,
        samples=samples)

    args = bank_nb.chain_args(xr_nb, xi_nb, state_nb)
    flops = ops1 + ops2 + NB_FLOPS_PER_SAMPLE * samples
    b_ms, b_by = bound(flops, 4 * samples * 4 + w_bytes + words_tails
                       + N_CHANNELS * (2 * 4 + 2 * 128 * 4))
    timing["sweep_chain_ssb_nb"] = dict(
        ms=time_ms(lambda: sweep.sweep_full_chain(*args), REPS),
        plain_ms=time_ms(lambda: sweep.sweep_full_chain_plain(*args), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=library_ms, flops=flops, samples=samples)
    seg_nb_ms = time_ms(lambda: bank_nb.process_planar(xr_nb, xi_nb, state_nb), REPS)
    del xr_nb, xi_nb

    args = bank_st.mix_demod_args(xr, xi, state_st)
    b_ms, b_by = bound(ops1, 3 * samples * 4 + 4 * 512 * 128 + N_CHANNELS * (2 * 8 + 256 * 4))
    timing["mix_demod"] = dict(
        ms=time_ms(lambda: staged.fused_mix_filter_demod(*args), REPS),
        plain_ms=time_ms(lambda: staged.fused_mix_filter_demod_plain(*args), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib1_ms, flops=ops1, samples=samples)
    audio = staged.fused_mix_filter_demod(*args)
    agc_ms = time_ms(lambda: agc.agc_run(audio, bank_st.agc_params, state_st.agc_env), REPS)
    args = bank_st.pbt_args(audio, state_st)
    b_ms, b_by = bound(ops2, 3 * samples * 4 + 4 * 256 * 256 + N_CHANNELS * 128 * 4)
    timing["pbt"] = dict(
        ms=time_ms(lambda: staged.pbt_filter(*args), REPS),
        plain_ms=time_ms(lambda: staged.pbt_filter_plain(*args), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib2_ms, flops=ops2, samples=samples)
    del audio, args
    seg_st_ms = time_ms(lambda: bank_st.process_planar(xr, xi, state_st), REPS)

    # the AM kernels at config1's shape; the library yardstick is the same two
    # products as fp32 torch.matmul
    samples_am = N_AM * SEG_LEN
    rows_am = samples_am // 128
    w_sb = bank_am.params.w_sideband
    f1 = torch.randn((rows_am, 512), generator=gen, device="cuda")
    f2 = torch.randn((rows_am, 256), generator=gen, device="cuda")
    lib_am_ms = time_ms(lambda: (torch.matmul(f1, w_sb), torch.matmul(f2, w_pbt)), REPS)
    del f1, f2
    ops_am = rows_am * 2 * 512 * 256 + rows_am * 2 * 256 * 256 + AM_FLOPS_PER_SAMPLE * samples_am
    bytes_am = (4 * samples_am * 4 + 4 * (512 * 256 + 256 * 256)
                + N_AM * (2 * 8 + 4 * 128 * 4 + 2 * 4 + 2 * 2 * 4))
    path_ms = {}
    for kname in ("sweep_chain_am", "sweep_chain_am_nb"):
        b, x_r, x_i, st = ends[kname]
        nb = kname.endswith("_nb")
        args = b.chain_args(x_r, x_i, st)
        flops = ops_am + (NB_FLOPS_PER_SAMPLE * samples_am if nb else 0)
        b_ms, b_by = bound(flops, bytes_am + (N_AM * (2 * 4 + 2 * 128 * 4) if nb else 0))
        timing[kname] = dict(
            ms=time_ms(lambda: sweep.sweep_am_chain(*args), REPS),
            plain_ms=time_ms(lambda: sweep.sweep_am_chain_plain(*args), 3),
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_am_ms, flops=flops,
            samples=samples_am)
        path_ms[f"AM{' + blanker' if nb else ''}"] = time_ms(
            lambda: b.process_planar(x_r, x_i, st), REPS)
    del xr_am, xi_am, xr_amnb, xi_amnb, args

    # K4 at config4's shape (64 ch x 2^19); the library yardstick is its four
    # products as fp32 torch.matmul
    samples4 = N_SPEC * SEG_LEN
    rows4 = samples4 // 128
    w_fwd, w_inv = bank4.w_spec
    f1 = torch.randn((rows4, 512), generator=gen, device="cuda")
    f2 = torch.randn((rows4, 256), generator=gen, device="cuda")
    lib_spec_ms = time_ms(lambda: (torch.matmul(f1, w_ssb), torch.matmul(f2, w_pbt),
                                   torch.matmul(f1, w_fwd), torch.matmul(f1, w_inv)), REPS)
    del f1, f2
    b4, x_r, x_i, st = ends["config4 fold=True"]
    args = b4.spec_args(x_r, x_i, st)
    b_ms, b_by = bound(SPEC_FLOPS_PER_SAMPLE * samples4,
                       4 * samples4 * 4 + 4 * (512 * 128 + 256 * 256 + 512 * 512 + 512 * 256)
                       + N_SPEC * (2 * 8 + 2 * 128 * 4 + 2 * 128 * 4 + 4 * 4 + 4 * 128 * 4))
    timing["sweep_spec_chain"] = dict(
        ms=time_ms(lambda: sweep_spec.sweep_spec_chain(*args), REPS),
        plain_ms=time_ms(lambda: sweep_spec.sweep_spec_chain_plain(*args), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_spec_ms,
        flops=SPEC_FLOPS_PER_SAMPLE * samples4, samples=samples4)
    del args
    # the staged spectral stage alone (plain PyTorch, split DFT) at config4's shape
    p4 = ends["config4 fold=False"][0].params
    l4, r4 = noise((N_SPEC, SEG_LEN), gen, 0.05), noise((N_SPEC, SEG_LEN), gen, 0.05)
    z4, t4 = torch.zeros(N_SPEC, device="cuda"), torch.zeros((N_SPEC, 128), device="cuda")
    spec_stage_ms = time_ms(lambda: planar.spectral_subtract_planar(
        l4, r4, p4.nr_level, z4, p4.dft_cos, p4.dft_sin, t4, t4), REPS)
    del l4, r4
    for label in ("config4 fold=True", "config4 fold=False", "ReceiverBank config4 SPEC2",
                  "config7 DNR2 fold=False", "config3 notch fold=False"):
        b, x_r, x_i, st = ends[label]
        path_ms[f"NR {label}"] = time_ms(lambda: b.process_planar(x_r, x_i, st), REPS)

    # the LMS kernel on config3's notch input of segment 1 (128 ch x 2^19); no
    # single PyTorch call computes it. Its plain version, a host-bound loop of
    # one step per sample, was timed in 4e on the first LMS_PREFIX samples of
    # the same input; plain_ms scales that time to the whole segment
    args = lms_args["config3 notch"]
    b_ms, b_by = bound(LMS_FLOPS_PER_SAMPLE * samples,
                       8 * samples + N_CHANNELS * 4 * (4 * 96 + 2 * 128))
    timing["lms_nr"] = dict(
        ms=time_ms(lambda: lms_bank.lms_nr_run_bank(*args), REPS),
        plain_ms=lms_plain_prefix_ms["config3 notch"] * (SEG_LEN / LMS_PREFIX),
        plain_from=LMS_PREFIX, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        flops=LMS_FLOPS_PER_SAMPLE * samples, samples=samples)
    del args, lms_args
    for label in ("config3 notch", "config7 DNR2"):
        rb, x_r, x_i, st = ends[label]
        path_ms[f"ReceiverBank {label}"] = time_ms(
            lambda: rb.process_planar(x_r, x_i, st), REPS)

    # the SAM kernels: K5 on config6's recorded segment-1 input, K6 at config6,
    # K7 at config10. plain_ms scales the time of the plain version on the
    # SAM_PREFIX-sample prefix (its per-sample PLL loop is host-bound) to the
    # segment; the library yardstick of K6 and K7 is their two products as
    # fp32 torch.matmul, and no single PyTorch call computes K5
    b6s, x_r, x_i, st = sam_ends["config6 fold=False"]
    samples6 = c6 * SEG_LEN
    b_ms, b_by = bound(PLL_FLOPS_PER_SAMPLE * samples6, 12 * samples6 + c6 * 4 * 4)
    timing["sam_pll"] = dict(
        ms=time_ms(lambda: sam.sam_pll_run(*pll_args), REPS),
        plain_ms=sam_plain_prefix_ms["sam_pll"] * (SEG_LEN / SAM_PREFIX),
        plain_from=SAM_PREFIX, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        flops=PLL_FLOPS_PER_SAMPLE * samples6, samples=samples6, steps=SEG_LEN)
    sam_stage_ms = {"front end (mix, band-pass)": time_ms(lambda: b6s.pll_args(x_r, x_i, st),
                                                          REPS)}
    vr = sam.sam_pll_run(*pll_args)[0]
    sam_stage_ms["dc_blocker"] = time_ms(lambda: iir.dc_blocker(vr, st.sam_dc), REPS)
    vr = iir.dc_blocker(vr, st.sam_dc)[0]
    sam_stage_ms["agc_run"] = time_ms(lambda: agc.agc_run(vr, b6s.agc_params, st.agc_env),
                                      REPS)
    del vr, pll_args
    path_ms["SAM config6 fold=False"] = time_ms(lambda: b6s.process_planar(x_r, x_i, st), REPS)
    w_sb = bank6.params.w_sideband
    lib_sam_ms = {}
    for kname, label in (("sweep_chain_sam", "SAM config6"),
                         ("sweep_chain_sam_nb", "SAM config6 + blanker"),
                         ("sam_wide", "SAM config10"), ("sam_wide_nb", "SAM config10 + blanker")):
        b, x_r, x_i, st = sam_ends[kname]
        c, n = x_r.shape
        samples_k, rows_k = c * n, c * n // 128
        if (c, n) not in lib_sam_ms:
            f1 = torch.randn((rows_k, 512), generator=gen, device="cuda")
            f2 = torch.randn((rows_k, 256), generator=gen, device="cuda")
            lib_sam_ms[(c, n)] = time_ms(lambda: (torch.matmul(f1, w_sb),
                                                  torch.matmul(f2, w_pbt)), REPS)
            del f1, f2
        nb = kname.endswith("_nb")
        flops = (rows_k * 2 * 512 * 256 + rows_k * 2 * 256 * 256
                 + (PLL_FLOPS_PER_SAMPLE + DC_FLOPS_PER_SAMPLE
                    + (NB_FLOPS_PER_SAMPLE if nb else 0)) * samples_k)
        b_ms, b_by = bound(flops, 4 * samples_k * 4 + 4 * (512 * 256 + 256 * 256)
                           + c * (2 * 8 + 4 * 128 * 4 + 2 * 4 + 2 * 2 * 4 + 2 * 2 * 4)
                           + (c * (2 * 4 + 2 * 128 * 4) if nb else 0))
        run = sam_wide.sweep_sam_wide if b.route == "wide" else sweep.sweep_sam_chain
        args = b.chain_args(x_r, x_i, st)
        timing[kname] = dict(
            ms=time_ms(lambda: run(*args), REPS),
            plain_ms=sam_plain_prefix_ms[kname] * (n / SAM_PREFIX), plain_from=SAM_PREFIX,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_sam_ms[(c, n)], flops=flops,
            samples=samples_k, steps=n)
        path_ms[label] = time_ms(lambda: b.process_planar(x_r, x_i, st), REPS)
    del args, sam_ends, xr6, xi6, xr6nb, xi6nb, xr10, xi10, xr10nb, xi10nb
    # the NR chain kernels: configs 3, 7 and 8 at full width, the other routes
    # at 128 ch x SEG_NR. plain_ms scales the plain chain's time on its checked
    # prefix (the per-sample LMS and PLL loops are host-bound) to the segment;
    # the library yardstick is the products the kernel computes, as fp32
    # torch.matmul; the bound adds the LMS's and the PLL's operations to the
    # products'
    lib_nr_ms = {}
    w_fwd, w_inv = bank4.w_spec
    for kname, (b, x_r, x_i, st) in nr_ends.items():
        c, n = x_r.shape
        samples_k, rows_k = c * n, c * n // 128
        dsb, spectral, denoise = b.demod != "ssb", b.nr == "spectral", b.nr == "denoise"
        w_band = b.params.w_sideband if dsb else b.params.w_ssb
        w_p = b.params.w_pbt[:, :128].contiguous() if denoise else b.params.w_pbt
        key = (n, dsb, denoise, spectral)
        if key not in lib_nr_ms:
            f1 = torch.randn((rows_k, 512), generator=gen, device="cuda")
            f2 = torch.randn((rows_k, 256), generator=gen, device="cuda")
            prods = [(f1, w_band), (f2, w_p)] + ([(f1, w_fwd), (f1, w_inv)] if spectral else [])
            lib_nr_ms[key] = time_ms(lambda: [torch.matmul(a, w) for a, w in prods], REPS)
            del f1, f2, prods
        per_sample = ((6 if b.demod == "am" else 0)
                      + (PLL_FLOPS_PER_SAMPLE + DC_FLOPS_PER_SAMPLE if b.demod == "sam" else 0)
                      + (NB_FLOPS_PER_SAMPLE if b.config.noise_blanker else 0)
                      + (0 if spectral else LMS_FLOPS_PER_SAMPLE))
        flops = (rows_k * 2 * (512 * w_band.shape[1] + 256 * w_p.shape[1])
                 + (rows_k * 2 * (512 * 512 + 512 * 256) if spectral else 0)
                 + per_sample * samples_k)
        nbytes = ((8 + (4 if denoise else 8)) * samples_k
                  + 4 * (512 * w_band.shape[1] + 256 * w_p.shape[1])
                  + (4 * (512 * 512 + 512 * 256) if spectral else 0)
                  + c * (2 * 8 + 4 * 128 * 4 + 2 * 4)
                  + (c * 2 * (96 + 96 + 128) * 4 if not spectral else c * 2 * (4 + 2 * 128 * 4))
                  + (c * 2 * 2 * 4 if dsb else 0) + (c * 2 * 2 * 4 if b.demod == "sam" else 0)
                  + (c * (2 * 4 + 2 * 128 * 4) if b.config.noise_blanker else 0))
        b_ms, b_by = bound(flops, nbytes)
        args = b.lanes_args(x_r, x_i, st)
        plain_ms, prefix = nr_plain_prefix[kname]
        timing[kname] = dict(
            ms=time_ms(lambda: lanes.sweep_lanes_chain(*args), REPS),
            plain_ms=plain_ms * (n / prefix), bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_nr_ms[key], flops=flops, samples=samples_k,
            **({"plain_from": prefix} if prefix < n else {}),
            **({} if spectral and b.demod != "sam" else {"steps": n}))
        path_ms[f"NR {b.config.mode.name} + {b.config.nr.name}"
                f"{' + blanker' if b.config.noise_blanker else ''} fold=True ({c} ch x {n})"] = \
            time_ms(lambda: b.process_planar(x_r, x_i, st), REPS)
    del args, nr_ends
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split("\n")[0]
    sm_now, sm_max = (float(v) for v in clocks.split(","))

    for kname, tm in timing.items():
        library = "none (no single PyTorch call)" if tm["library_ms"] is None else \
            f"{tm['library_ms']:.3f} ms"
        step = "" if "steps" not in tm else (
            f", {tm['ms'] * 1e6 / tm['steps']:.2f} ns per dependent step = "
            f"{tm['ms'] * 1e-3 / tm['steps'] * sm_max * 1e6:.1f} cycles at {sm_max:.0f} MHz")
        say(f"timing {kname}: kernel {tm['ms']:.3f} ms/segment "
            f"({tm['samples'] / tm['ms'] / 1e3:.1f} "
            f"Msamples/s, {tm['flops'] / tm['ms'] / 1e9:.1f} TFLOP/s fp32{step}), plain "
            f"{tm['plain_ms']:.3f} ms"
            + (f" (timed on the first {tm['plain_from']} samples, scaled to the "
               f"segment)" if "plain_from" in tm else "")
            + f", library {library}, bound "
            f"{tm['bound_ms']:.3f} ms ({tm['bound_by']})")
    say(f"timing paths: FusedSSBBank.process_planar per segment: sweep {seg_ms:.3f} ms, "
        f"staged {seg_st_ms:.3f} ms (of which agc_run {agc_ms:.3f} ms), noise blanker "
        f"{seg_nb_ms:.3f} ms; "
        + "; ".join(f"{k} {v:.3f} ms" for k, v in path_ms.items())
        + f" (AM and config4 {N_AM} ch, SAM config10 {N_SAM_WIDE} ch x {SEG_WIDE}, the rest "
        f"{N_CHANNELS} ch); the staged SAM path's plain stages: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in sam_stage_ms.items())
        + f"; SM clock {sm_now:.0f} MHz after the timing, max {sm_max:.0f} MHz; library: "
        f"torch.matmul (rows,512)@(512,128) {lib1_ms:.3f} ms, (rows,256)@(256,256) "
        f"{lib2_ms:.3f} ms, both {library_ms:.3f} ms, with PBT's L half alone "
        f"{library_mono_ms:.3f} ms; K4's four products at config4 "
        f"{lib_spec_ms:.3f} ms; the staged spectral stage (planar.spectral_subtract_planar) "
        f"alone at config4 {spec_stage_ms:.3f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")

    # 6. the per-kernel record
    sources = {"sweep_chain_ssb": ("sweep_chain.cu", "pallas_sweep.py:261"),
               "sweep_chain_ssb_nb": ("sweep_chain.cu", "pallas_sweep.py:261"),
               "mix_demod": ("staged.cu", "pallas_kernels.py:83"),
               "pbt": ("staged.cu", "pallas_kernels.py:177"),
               "sweep_chain_am": ("sweep_chain.cu", "pallas_sweep.py:261"),
               "sweep_chain_am_nb": ("sweep_chain.cu", "pallas_sweep.py:261"),
               "lms_nr": ("lms.cu", "pallas_lms.py:36"),
               "sweep_chain_ssb_mono": ("sweep_chain.cu", "pallas_sweep.py:261"),
               "sweep_spec_chain": ("sweep_spec.cu", "pallas_sweep_spec.py:46"),
               "sam_pll": ("sam.cu", "pallas_sam.py:226"),
               "sweep_chain_sam": ("sweep_chain.cu", "pallas_chain_lanes.py:98"),
               "sweep_chain_sam_nb": ("sweep_chain.cu", "pallas_chain_lanes.py:98"),
               "sam_wide": ("sam_wide.cu", "pallas_sam_wide.py:49"),
               "sam_wide_nb": ("sam_wide.cu", "pallas_sam_wide.py:49"),
               **{k: (f"{sweep.LIBRARIES[k.split('_')[2]]}.cu", "pallas_chain_lanes.py:98")
                  for k in lanes.KERNELS}}
    print(json.dumps({"kernels": [{
        "name": kname, "route": "cuda",
        "source": f"radiodsp_sdr_rx_tpu_torch/csrc/{src}",
        "replaces": f"radiodsp_sdr_rx_tpu/ops/{tpu}",
        "launches": launches[kname], "max_abs_err": err[kname],
        "ms": timing[kname]["ms"], "plain_ms": timing[kname]["plain_ms"],
        "bound_ms": timing[kname]["bound_ms"], "bound_by": timing[kname]["bound_by"],
        "library_ms": timing[kname]["library_ms"],
        "plain_timed_samples": timing[kname].get("plain_from", SEG_LEN)}
        for kname, (src, tpu) in sources.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
