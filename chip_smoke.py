#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's kernels from ``radiodsp_sdr_rx_tpu_torch/csrc`` with nvcc
(one nvcc per source, all started together), holds each kernel against its
plain PyTorch version, drives three paths of the 128-channel USB
``FusedSSBBank`` of bench.py at full width (2^19-sample segments, state
threaded between them) through the kernels, and times them:

  - the main path, backend="sweep": kernel sweep_chain_ssb, 1 launch/segment;
  - the staged path, backend="staged": kernels mix_demod and pbt with the AGC
    between them in PyTorch, 2 launches/segment;
  - the noise-blanker path, noise_blanker=True: kernel sweep_chain_ssb_nb,
    1 launch/segment.

Every phase prints one flushed line with the seconds elapsed. Any failure
raises and exits non-zero; without a CUDA card it exits non-zero at once.
The last line is {"ok": true, "device": {...}}; the line before it is the
per-kernel JSON record.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

T0 = time.perf_counter()
TOL = 1e-4           # kernel vs plain, both fp32: sums taken in another order
TOL_BACKENDS = 2e-4  # staged vs sweep backend (tests/test_fused_bank.py:66-88)
N_CHANNELS = 128     # bench.py:38
SEG_LEN = 1 << 19    # bench.py:39
SEGMENTS = 3         # threaded segments of each full-width run
REPS = 10            # timed segments
PEAK_BYTES_S = 3.35e12   # H100 SXM device memory
PEAK_FP32_S = 67e12      # H100 SXM fp32 outside the tensor cores
NB_FLOPS_PER_SAMPLE = 10  # |x|, the one-pole average, the threshold test
LIBRARIES = ("sweep_chain", "staged")


def say(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f} s] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def max_diff(got, ref) -> float:
    return max(float((g - r).abs().max()) for g, r in zip(got, ref))


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def noise(shape, gen, scale=0.1):
    import torch

    return torch.randn(shape, generator=gen, device="cuda") * scale


def nb_scene(c, n, gen):
    """The decisive noise-blanker scene of tests/test_fused_bank.py:496-545:
    noise with a 2x burst (the AGC attacks, then releases), its magnitude
    clipped to 2.2x its mean so that no noise sample lies near the blanking
    threshold, and impulses of 8(1+1j) far above it, one on the last sample.
    Returns (xr, xi, mean magnitude), the last to warm-start the average."""
    import torch

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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32_S, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def main() -> None:
    import torch

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

    from radiodsp_sdr_rx_tpu_torch.models.config import AGCMode, DemodMode, ReceiverConfig
    from radiodsp_sdr_rx_tpu_torch.models.fused import FusedSSBBank
    from radiodsp_sdr_rx_tpu_torch.ops import agc, staged, sweep
    from radiodsp_sdr_rx_tpu_torch.utils import build

    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False

    def reset_counts() -> None:
        sweep.LAUNCHES = sweep.LAUNCHES_NB = 0
        staged.LAUNCHES_MIX_DEMOD = staged.LAUNCHES_PBT = 0

    def counts() -> dict:
        return {"sweep_chain_ssb": sweep.LAUNCHES, "sweep_chain_ssb_nb": sweep.LAUNCHES_NB,
                "mix_demod": staged.LAUNCHES_MIX_DEMOD, "pbt": staged.LAUNCHES_PBT}

    # 2. the kernel builds, one nvcc per source, all at once
    t = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        list(pool.map(build.load_library, LIBRARIES))
    say(f"build: csrc/{{{','.join(LIBRARIES)}}}.cu with nvcc for sm_90a in "
        f"{time.perf_counter() - t:.2f} s")
    for lib in LIBRARIES:
        for line in build.build_log(lib).splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                say(f"ptxas {lib}: {line.strip()}")

    cfg = ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_200_000.0,
                         capture_center_freq=7_190_000.0, agc=AGCMode.MEDIUM)
    cfg_nb = cfg.with_(noise_blanker=True)
    freqs = [7_190_000.0 + 1_000.0 * k for k in range(N_CHANNELS)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = dict.fromkeys(("sweep_chain_ssb", "sweep_chain_ssb_nb", "mix_demod", "pbt"), 0.0)

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
    del small, small_nb, small_st

    def drive(bank, xr, xi, state, label):
        """SEGMENTS threaded segments with the launch counts set to 0 before and
        read after; returns (launches, state into segment 1, its output, the
        state out of it, the final state and output)."""
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
        say(f"{label}: {N_CHANNELS} ch x {SEG_LEN} samples, {SEGMENTS} threaded segments "
            f"in {time.perf_counter() - t:.3f} s, kernel launches {launched}")
        for key in ("audio_l", "audio_r"):
            check(tuple(out[key].shape) == (N_CHANNELS, SEG_LEN), f"{key} shape {tuple(out[key].shape)}")
            check(bool(torch.isfinite(out[key]).all()), f"{key} has non-finite values")
        return launched, state_1, out_1, state_2, state

    # 4. the main path at full width: 128 ch x 2^19, threaded segments
    bank = FusedSSBBank(cfg, freqs)
    xr, xi = noise((N_CHANNELS, SEG_LEN), gen), noise((N_CHANNELS, SEG_LEN), gen)
    launched, state_1, out_1, state_2, state = drive(bank, xr, xi, bank.init_state(), "main path")
    check(launched == {"sweep_chain_ssb": SEGMENTS, "sweep_chain_ssb_nb": 0, "mix_demod": 0,
                       "pbt": 0}, f"expected {SEGMENTS} sweep_chain_ssb launches and no "
          f"other, counted {launched}")
    launches = {"sweep_chain_ssb": launched["sweep_chain_ssb"]}
    ref = sweep.sweep_full_chain_plain(*bank.chain_args(xr, xi, state_1))
    d = max_diff((out_1["audio_l"], out_1["audio_r"], state_2.audio_tail, state_2.agc_env), ref)
    rms = float(out_1["audio_l"].square().mean().sqrt())
    say(f"check full width, segment 1: max |kernel - plain| = {d:.3e} "
        f"(tolerance {TOL:g}); output finite, rms(L) = {rms:.4f}")
    check(d <= TOL, f"sweep_chain_ssb disagrees at full width: {d:.3e} > {TOL:g}")
    err["sweep_chain_ssb"] = max(err["sweep_chain_ssb"], d)
    sweep_out_1 = out_1
    del ref, out_1

    # 4b. the staged path at full width, on the same input
    bank_st = FusedSSBBank(cfg, freqs, backend="staged")
    launched, st_1, out_1, st_2, state_st = drive(bank_st, xr, xi, bank_st.init_state(),
                                                  "staged path")
    check(launched == {"sweep_chain_ssb": 0, "sweep_chain_ssb_nb": 0, "mix_demod": SEGMENTS,
                       "pbt": SEGMENTS}, f"expected {SEGMENTS} launches each of mix_demod "
          f"and pbt (2 per segment) and no other, counted {launched}")
    launches.update(mix_demod=launched["mix_demod"], pbt=launched["pbt"])
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
    check(launched == {"sweep_chain_ssb": 0, "sweep_chain_ssb_nb": SEGMENTS, "mix_demod": 0,
                       "pbt": 0}, f"expected {SEGMENTS} sweep_chain_ssb_nb launches and "
          f"no other, counted {launched}")
    launches["sweep_chain_ssb_nb"] = launched["sweep_chain_ssb_nb"]
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

    # 5. timing (CUDA events, after warm-up)
    samples = N_CHANNELS * SEG_LEN
    rows = samples // 128
    w_ssb, w_pbt = bank.params.w_ssb, bank.params.w_pbt
    f1 = torch.randn((rows, 512), generator=gen, device="cuda")
    f2 = torch.randn((rows, 256), generator=gen, device="cuda")
    lib1_ms = time_ms(lambda: torch.matmul(f1, w_ssb), REPS)
    lib2_ms = time_ms(lambda: torch.matmul(f2, w_pbt), REPS)
    library_ms = time_ms(lambda: (torch.matmul(f1, w_ssb), torch.matmul(f2, w_pbt)), REPS)
    del f1, f2
    ops1, ops2 = rows * 2 * 512 * 128, rows * 2 * 256 * 256
    words_tails = N_CHANNELS * (2 * 8 + 4 * 128 * 4 + 2 * 4)
    w_bytes = 4 * (512 * 128 + 256 * 256)
    timing = {}

    args = bank.chain_args(xr, xi, state)
    b_ms, b_by = bound(ops1 + ops2, 4 * samples * 4 + w_bytes + words_tails)
    timing["sweep_chain_ssb"] = dict(
        ms=time_ms(lambda: sweep.sweep_full_chain(*args), REPS),
        plain_ms=time_ms(lambda: sweep.sweep_full_chain_plain(*args), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=library_ms, flops=ops1 + ops2)
    seg_ms = time_ms(lambda: bank.process_planar(xr, xi, state), REPS)

    args = bank_nb.chain_args(xr_nb, xi_nb, state_nb)
    flops = ops1 + ops2 + NB_FLOPS_PER_SAMPLE * samples
    b_ms, b_by = bound(flops, 4 * samples * 4 + w_bytes + words_tails
                       + N_CHANNELS * (2 * 4 + 2 * 128 * 4))
    timing["sweep_chain_ssb_nb"] = dict(
        ms=time_ms(lambda: sweep.sweep_full_chain(*args), REPS),
        plain_ms=time_ms(lambda: sweep.sweep_full_chain_plain(*args), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=library_ms, flops=flops)
    seg_nb_ms = time_ms(lambda: bank_nb.process_planar(xr_nb, xi_nb, state_nb), REPS)
    del xr_nb, xi_nb

    args = bank_st.mix_demod_args(xr, xi, state_st)
    b_ms, b_by = bound(ops1, 3 * samples * 4 + 4 * 512 * 128 + N_CHANNELS * (2 * 8 + 256 * 4))
    timing["mix_demod"] = dict(
        ms=time_ms(lambda: staged.fused_mix_filter_demod(*args), REPS),
        plain_ms=time_ms(lambda: staged.fused_mix_filter_demod_plain(*args), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib1_ms, flops=ops1)
    audio = staged.fused_mix_filter_demod(*args)
    agc_ms = time_ms(lambda: agc.agc_run(audio, bank_st.agc_params, state_st.agc_env), REPS)
    args = bank_st.pbt_args(audio, state_st)
    b_ms, b_by = bound(ops2, 3 * samples * 4 + 4 * 256 * 256 + N_CHANNELS * 128 * 4)
    timing["pbt"] = dict(
        ms=time_ms(lambda: staged.pbt_filter(*args), REPS),
        plain_ms=time_ms(lambda: staged.pbt_filter_plain(*args), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib2_ms, flops=ops2)
    del audio, args
    seg_st_ms = time_ms(lambda: bank_st.process_planar(xr, xi, state_st), REPS)

    for kname, tm in timing.items():
        say(f"timing {kname}: kernel {tm['ms']:.3f} ms/segment ({samples / tm['ms'] / 1e3:.1f} "
            f"Msamples/s, {tm['flops'] / tm['ms'] / 1e9:.1f} TFLOP/s fp32), plain "
            f"{tm['plain_ms']:.3f} ms, library {tm['library_ms']:.3f} ms, bound "
            f"{tm['bound_ms']:.3f} ms ({tm['bound_by']})")
    say(f"timing paths: FusedSSBBank.process_planar per segment: sweep {seg_ms:.3f} ms, "
        f"staged {seg_st_ms:.3f} ms (of which agc_run {agc_ms:.3f} ms), noise blanker "
        f"{seg_nb_ms:.3f} ms; library: "
        f"torch.matmul (rows,512)@(512,128) {lib1_ms:.3f} ms, (rows,256)@(256,256) "
        f"{lib2_ms:.3f} ms, both {library_ms:.3f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")

    # 6. the per-kernel record
    sources = {"sweep_chain_ssb": ("sweep_chain.cu", "pallas_sweep.py:261"),
               "sweep_chain_ssb_nb": ("sweep_chain.cu", "pallas_sweep.py:261"),
               "mix_demod": ("staged.cu", "pallas_kernels.py:83"),
               "pbt": ("staged.cu", "pallas_kernels.py:177")}
    print(json.dumps({"kernels": [{
        "name": kname, "route": "cuda",
        "source": f"radiodsp_sdr_rx_tpu_torch/csrc/{src}",
        "replaces": f"radiodsp_sdr_rx_tpu/ops/{tpu}",
        "launches": launches[kname], "max_abs_err": err[kname],
        "ms": timing[kname]["ms"], "plain_ms": timing[kname]["plain_ms"],
        "bound_ms": timing[kname]["bound_ms"], "bound_by": timing[kname]["bound_by"],
        "library_ms": timing[kname]["library_ms"]}
        for kname, (src, tpu) in sources.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
