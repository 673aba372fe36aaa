#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's kernel from ``radiodsp_sdr_rx_tpu_torch/csrc`` with nvcc,
holds it against its plain PyTorch version, drives the main path (the
128-channel USB ``FusedSSBBank`` of bench.py at full width, 2^19-sample
segments with state threaded between them) through the kernel, and times it.
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

T0 = time.perf_counter()
TOL = 1e-4           # kernel vs plain, both fp32: sums taken in another order
N_CHANNELS = 128     # bench.py:38
SEG_LEN = 1 << 19    # bench.py:39
SEGMENTS = 3         # threaded segments of the main-path run
REPS = 10            # timed segments
PEAK_BYTES_S = 3.35e12   # H100 SXM device memory
PEAK_FP32_S = 67e12      # H100 SXM fp32 outside the tensor cores


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
    from radiodsp_sdr_rx_tpu_torch.ops import sweep
    from radiodsp_sdr_rx_tpu_torch.utils import build

    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in full fp32
    torch.backends.cudnn.allow_tf32 = False

    # 2. the kernel build
    t = time.perf_counter()
    build.load_library("sweep_chain")
    say(f"build: csrc/sweep_chain.cu with nvcc for sm_90a in {time.perf_counter() - t:.2f} s")
    for line in build.build_log("sweep_chain").splitlines():
        if "registers" in line or "spill" in line:
            say(f"ptxas: {line.strip()}")

    cfg = ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_200_000.0,
                         capture_center_freq=7_190_000.0, agc=AGCMode.MEDIUM)
    freqs = [7_190_000.0 + 1_000.0 * k for k in range(N_CHANNELS)]
    gen = torch.Generator(device="cuda").manual_seed(0)

    # 3. kernel vs plain version, 8 channels x 8192, two threaded segments
    small = FusedSSBBank(cfg, freqs[:8])
    state = small.init_state()
    err_small = 0.0
    for seg in range(2):
        xr, xi = noise((8, 8192), gen), noise((8, 8192), gen)
        xr[:, 3000:3400] *= 30.0   # a burst: AGC attack, then release
        ref = sweep.sweep_full_chain_plain(*small.chain_args(xr, xi, state))
        out, state = small.process_planar(xr, xi, state)
        torch.cuda.synchronize()
        d = max_diff((out["audio_l"], out["audio_r"], state.audio_tail, state.agc_env), ref)
        say(f"check 8 ch x 8192, segment {seg}: max |kernel - plain| over L, R, "
            f"audio_tail, env = {d:.3e} (tolerance {TOL:g})")
        check(d <= TOL, f"kernel disagrees with the plain version: {d:.3e} > {TOL:g}")
        err_small = max(err_small, d)

    # 4. the main path at full width: 128 ch x 2^19, threaded segments
    bank = FusedSSBBank(cfg, freqs)
    xr, xi = noise((N_CHANNELS, SEG_LEN), gen), noise((N_CHANNELS, SEG_LEN), gen)
    state = bank.init_state()
    torch.cuda.synchronize()
    t = time.perf_counter()
    sweep.LAUNCHES = 0
    for seg in range(SEGMENTS):
        if seg == 1:
            state_1 = state
        out, state = bank.process_planar(xr, xi, state)
        if seg == 1:
            out_1, state_2 = out, state
    torch.cuda.synchronize()
    launches = sweep.LAUNCHES
    say(f"main path: FusedSSBBank {N_CHANNELS} ch x {SEG_LEN} samples, {SEGMENTS} "
        f"threaded segments in {time.perf_counter() - t:.3f} s, kernel launches {launches}")
    check(launches == SEGMENTS, f"expected {SEGMENTS} kernel launches, counted {launches}")
    for key in ("audio_l", "audio_r"):
        check(tuple(out[key].shape) == (N_CHANNELS, SEG_LEN), f"{key} shape {tuple(out[key].shape)}")
        check(bool(torch.isfinite(out[key]).all()), f"{key} has non-finite values")
    ref = sweep.sweep_full_chain_plain(*bank.chain_args(xr, xi, state_1))
    err_full = max_diff((out_1["audio_l"], out_1["audio_r"], state_2.audio_tail,
                         state_2.agc_env), ref)
    rms = float(out_1["audio_l"].square().mean().sqrt())
    say(f"check full width, segment 1: max |kernel - plain| = {err_full:.3e} "
        f"(tolerance {TOL:g}); output finite, rms(L) = {rms:.4f}")
    check(err_full <= TOL, f"kernel disagrees at full width: {err_full:.3e} > {TOL:g}")
    del ref, out_1, out

    # 5. timing (CUDA events, after warm-up)
    args = bank.chain_args(xr, xi, state)
    kernel_ms = time_ms(lambda: sweep.sweep_full_chain(*args), REPS)
    seg_ms = time_ms(lambda: bank.process_planar(xr, xi, state), REPS)
    plain_ms = time_ms(lambda: sweep.sweep_full_chain_plain(*args), 3)
    rows = N_CHANNELS * SEG_LEN // 128
    f1 = torch.randn((rows, 512), generator=gen, device="cuda")
    f2 = torch.randn((rows, 256), generator=gen, device="cuda")
    library_ms = time_ms(lambda: (torch.matmul(f1, bank.params.w_ssb),
                                  torch.matmul(f2, bank.params.w_pbt)), REPS)
    samples = N_CHANNELS * SEG_LEN
    flops = rows * 2 * (512 * 128 + 256 * 256)
    nbytes = (4 * samples * 4                      # xr, xi in; L, R out
              + 4 * (512 * 128 + 256 * 256)        # the two operators
              + N_CHANNELS * (2 * 8 + 4 * 128 * 4 + 2 * 4))  # words, tails, env
    bound_ms = max(nbytes / PEAK_BYTES_S, flops / PEAK_FP32_S) * 1e3
    bound_by = "operations" if flops / PEAK_FP32_S > nbytes / PEAK_BYTES_S else "bytes"
    say(f"timing: kernel {kernel_ms:.3f} ms/segment ({samples / kernel_ms / 1e3:.1f} Msamples/s, "
        f"{flops / kernel_ms / 1e9:.1f} TFLOP/s fp32), FusedSSBBank.process_planar "
        f"{seg_ms:.3f} ms/segment, plain {plain_ms:.3f} ms, library (two torch.matmul) "
        f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")

    # 6. the per-kernel record
    print(json.dumps({"kernels": [{
        "name": "sweep_chain_ssb", "route": "cuda",
        "source": "radiodsp_sdr_rx_tpu_torch/csrc/sweep_chain.cu",
        "replaces": "radiodsp_sdr_rx_tpu/ops/pallas_sweep.py:261",
        "launches": launches, "max_abs_err": max(err_small, err_full),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
