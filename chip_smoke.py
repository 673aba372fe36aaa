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
    PyTorch; lms_nr held to its plain version (the grouped algebra) over
    the three whole threaded segments;
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
    against its plain chain over whole threaded segments (with SAM on a
    prefix of SAM_PREFIX samples: the plain PLL is one host-bound step per
    sample), each bank against ``ReceiverBank``, configs 3 and 7 folded
    against staged; the LMS kernels' cycles per LMS step; the six spectral
    routes (K4 and K6's five, whose stage is an in-block FFT) timed beside
    the bound of the work they do, on the card and on the SMs their bank
    fills, and the bound of the TPU design's dense DFT products;
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
    threaded as two segments, and the full run's first samples; K5,
    sweep_chain_sam, sam_wide and lanes_sam_spectral also over a long run,
    SAM_LONG samples as two threaded segments at full width, against the
    plain versions on the CPU copy of SAM_LONG_ROWS channels spread over the
    bank (sam_wide: its first and last blocks, 16 channels; SAM + spectral
    frame by frame); each route against
    ``ReceiverBank(mode=SAM)`` on a prefix; K7 against K6 at 1,024 channels
    over two full segments; the PLL step's pieces (csrc/sam.cu's probe: the
    explicit divide bit for bit against IEEE division, the atan2 within
    ATAN2_ULPS ulps of the plain one); cycles per PLL step beside the walk's
    own pace (sam_pll's);
  - K8, ``sweep_mix_filter_demod`` (mix + band-pass + SSB demod from a
    stream start), at tools/bench_sweep.py's shapes (128 channels x 2^19):
    kernel sweep_mix_demod, 1 launch/call, held to its plain version, to
    mix_demod with a zero tail and across chunk_t, timed as the tool times
    it (a chain of calls, each on the previous output);
  - the single-channel ``Receiver``, the model the CLI runs: on the six
    golden scenes (rebuilt by the port's utils/scenes.py) held to
    tests/goldens/*.npz, its NOTCH case's LMS on lms_nr; against the same
    Receiver on the CPU at fft_length 512 (DNR2), with conv_first and with
    the inline denoise; the I2S-slip repair sequence with hysteresis on a
    mid-stream slip; and timed per 16,384-sample CLI block (NR off, NOTCH,
    SPEC2) with its real-time factor;
  - the sharded paths (``radiodsp_sdr_rx_tpu_torch/parallel``) on meshes
    that name cuda:0 once per shard: K9, ``ring_shift`` (the ring halo), on
    rings of 2, 4 and 8 shards, f32 and complex64, bit for bit with its
    plain copies, one launch per exchange, timed as a chain of 100
    exchanges; ``make_time_sharded_ssb_chain`` (USB and AM, a 2^21-sample
    stream on time=4) with the kernel halo, 2 launches a call, bit for bit
    with the ppermute halo and against the unsharded ``Receiver``;
    ``make_full_sharded_chain`` on channel=2 x time=4: the fifteen mode x NR
    x blanker combos of ``__graft_entry__.dryrun_multichip`` (8 channels x
    2 x 8,192, a locked-carrier scene) against the unsharded chain and split
    against unbroken, and USB + DNR (K3, one launch a segment) and USB +
    spectral at 128 channels x 2^19; ``ShardedFusedBank`` of the SSB bank,
    1,024 channels x 2^17 on channel=8, bit for bit with the one bank; and
    ``ReceiverBank(backend="vmap")`` with DNR2 at 129 channels (fault F1).

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
from pathlib import Path

import numpy as np
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
SAM_LONG = 1 << 17   # the long run of the PLL kernels, two threaded segments
SAM_LONG_ROWS = 8    # its channels, spread over the bank, their plain loop on the CPU
ATAN2_ULPS = 4       # device atan2 vs plain: the kernel's FMAs against separate products
N_AM = 64            # bench_full.py config1_am_64ch
N_SPEC = 64          # bench_full.py config4_spec_nr_64ch
SEG_LEN = 1 << 19    # bench.py:39
SEGMENTS = 3         # threaded segments of each full-width run
REPS = 10            # timed segments
TOL_K8_K2A = 2e-5    # K8 vs mix_demod with a zero tail (tests/test_pallas_sweep.py:30)
TOL_CHUNK = 1e-5     # K8 across chunk_t
K8_INC = 123456789   # tools/bench_sweep.py's DDS increment
CLI_BLOCK = 16384    # samples per Receiver call in the CLI (cli.py:389)
CLI_BLOCKS = 32      # threaded blocks of each timed Receiver run
PROFILED_BLOCKS = 4  # blocks of each Receiver run traced by the profiler
FS = 44117.647       # samples per second per channel
GOLDENS = Path(__file__).resolve().parent / "tests" / "goldens"
PEAK_BYTES_S = 3.35e12   # H100 SXM device memory
PEAK_FP32_S = 67e12      # H100 SXM fp32 outside the tensor cores
NB_FLOPS_PER_SAMPLE = 10  # |x|, the one-pole average, the threshold test
AM_FLOPS_PER_SAMPLE = 6   # the envelope and the DC blocker
DC_FLOPS_PER_SAMPLE = 3   # the DC blocker alone
LMS_FLOPS_PER_SAMPLE = 6 * 96   # the 96-tap dot, the energy and the update
# the spectral stage's work per 128-sample row: one forward and one inverse
# 256-point FFT of 7,296 flops each (two radix-8 stages of 32 eight-point
# DFTs of 56 flops and 7 twiddle products of 6, then 64 four-point DFTs of
# 16), the magnitudes (4 flops a bin, the square root one), the VAD sum
# (151), the scale (max, divide, subtract, compare and the two products a
# bin) and the output gain (one product a sample)
FFT_FLOPS = 2 * 32 * (56 + 7 * 6) + 64 * 16
SPEC_STAGE_FLOPS_PER_ROW = 2 * FFT_FLOPS + 256 * 4 + 151 + 256 * 6 + 256
# what the kernels do above it: they keep no spectra across the floor scan
# and run each row's forward FFT and magnitudes again after it
SPEC_RECOMPUTE_FLOPS_PER_ROW = FFT_FLOPS + 256 * 4
# the same stage as the TPU kernel's dense DFT products: W_fwd (512 x 512) and
# W_inv (512 x 256), 6,144 flops a sample (the bound in brackets, PERF.md)
SPEC_DENSE_FLOPS_PER_ROW = 2 * (512 * 512 + 512 * 256)
# K4: the chain's two products (2,048 a sample) and the stage
SPEC_FLOPS_PER_SAMPLE = (2 * (512 * 128 + 256 * 256) + SPEC_STAGE_FLOPS_PER_ROW) / 128
# the PLL step: the two products, the atan2 (a divide counted as one), the
# loop update, the base oscillator's two Horner chains, the rotation
PLL_FLOPS_PER_SAMPLE = 72
# the PLL step's dependent path from err[n] to err[n+1], read from the SASS
# of csrc/sam_pll.cuh (cuobjdump of sam.cu's build; PERF.md section 6),
# instructions by latency kind of LATENCY_KINDS: the clip bounds, the two
# clamps, the rotation's two FMA levels, hi, lo + hi and its clamp, the
# reciprocal and the divide's Newton step, quotient, residual and
# correction, the Estrin polynomial. Printed beside the cycles per step as
# the chain bound; not part of the kernels line.
PLL_PATH = {"FFMA": 12, "FMNMX": 4, "MUFU.RCP + FFMA": 1}
# cycles per link of dependent chains of the PLL step's instruction kinds,
# one thread timing each chain of LATENCY_LINKS links with clock64: 0 FFMA,
# 1 FMNMX, 2 a compare and a select (FSETP, FSEL), 3 a compare and a
# predicated FADD on the fresh predicate, 4 MUFU.RCP and an FFMA. Only this
# script prices the path, so the source is built here, beside the package's.
LATENCY_KINDS = ("FFMA", "FMNMX", "FSETP + FSEL", "FSETP + predicated FADD",
                 "MUFU.RCP + FFMA")
LATENCY_LINKS = 256
LATENCY_SRC = r"""
#include <cuda_runtime.h>
#define LINKS %d
__global__ void pll_latency_kernel(long long* cycles, float* sink, float a, float b) {
  float x = a;
  long long t = clock64();
#pragma unroll
  for (int i = 0; i < LINKS; ++i) asm volatile("fma.rn.f32 %%0, %%0, %%1, %%2;" : "+f"(x) : "f"(b), "f"(a));
  cycles[0] = clock64() - t;
  t = clock64();
#pragma unroll
  for (int i = 0; i < LINKS; ++i) asm volatile("max.f32 %%0, %%0, %%1;" : "+f"(x) : "f"(b));
  cycles[1] = clock64() - t;
  t = clock64();
#pragma unroll
  for (int i = 0; i < LINKS; ++i)
    asm volatile("{.reg .pred p; setp.gt.f32 p, %%0, %%1; selp.f32 %%0, %%2, %%0, p;}"
                 : "+f"(x) : "f"(b), "f"(a));
  cycles[2] = clock64() - t;
  t = clock64();
#pragma unroll
  for (int i = 0; i < LINKS; ++i)
    asm volatile("{.reg .pred p; setp.gt.f32 p, %%0, %%1; @p add.f32 %%0, %%0, %%2;}"
                 : "+f"(x) : "f"(b), "f"(a));
  cycles[3] = clock64() - t;
  t = clock64();
#pragma unroll
  for (int i = 0; i < LINKS; ++i)
    asm volatile("{.reg .f32 r; rcp.approx.ftz.f32 r, %%0; fma.rn.f32 %%0, r, %%1, %%2;}"
                 : "+f"(x) : "f"(b), "f"(a));
  cycles[4] = clock64() - t;
  *sink = x;
}
extern "C" int pll_latency(long long* cycles, float* sink) {
  pll_latency_kernel<<<1, 1>>>(cycles, sink, 1.0001f, 0.9999f);
  return (int)cudaGetLastError();
}
""" % LATENCY_LINKS
LIBRARIES = ("sweep_chain", "staged", "lms", "sweep_spec", "sam", "sam_wide", "sweep_denoise",
             "sweep_notch", "halo")


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
        elif "sam_chain_kernel" in mangled:
            nb, nr = re.search(r"sam_chain_kernelILb(\d)EL\w*?NrE(\d)E", mangled).groups()
            kname = kernel_of(2, nb == "1", int(nr), nr != "1")
        elif "sam_wide_kernel" in mangled:
            g, nb = re.search(r"sam_wide_kernelILi(\d)ELb(\d)E", mangled).groups()
            kname = f"sam_wide{'_nb' if nb == '1' else ''} (G={g})"
        else:
            kname = next(k for fn, k in (("mix_demod_kernelILb0", "sweep_mix_demod"),
                                         ("mix_demod_kernel", "mix_demod"), ("pbt_kernel", "pbt"),
                                         ("lms_kernel", "lms_nr"),
                                         ("sam_pll_kernel", "sam_pll"),
                                         ("sam_probe_kernel", "sam_probe"),
                                         ("ring_shift_kernel", "ring_shift"))
                         if fn in mangled)
        lines = block.splitlines()
        out.append((kname, next(ln for ln in lines if "registers" in ln).split(": ")[-1],
                    next(ln for ln in lines if "spill" in ln).strip()))
    return out


def build_latency_probe():
    """LATENCY_SRC built with the package's nvcc flags into its build
    directory (ignored by git), loaded with ctypes."""
    import ctypes
    from radiodsp_sdr_rx_tpu_torch.utils import build
    build.BUILD_DIR.mkdir(exist_ok=True)
    src, so = build.BUILD_DIR / "pll_latency.cu", build.BUILD_DIR / "libpll_latency.so"
    src.write_text(LATENCY_SRC)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)],
                          capture_output=True, text=True)
    check(proc.returncode == 0, f"nvcc failed on the latency chains:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(so))


def latency_probe(lib) -> dict:
    """Cycles per link of each kind of LATENCY_KINDS on the current card."""
    cycles = torch.zeros(len(LATENCY_KINDS), dtype=torch.int64, device="cuda")
    sink = torch.zeros(1, device="cuda")
    check(lib.pll_latency(ctypes_ptr(cycles), ctypes_ptr(sink)) == 0,
          "the latency chains did not launch")
    torch.cuda.synchronize()
    return {k: float(v) / LATENCY_LINKS for k, v in zip(LATENCY_KINDS, cycles.tolist())}


def ctypes_ptr(t):
    import ctypes
    return ctypes.c_void_p(t.data_ptr())


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


def unsharded_full_chain(mode, nr, nb, iq, incs, p, st, mu):
    """The per-channel chain that ``make_full_sharded_chain`` shards, on one
    device, from the port's ops (``__graft_entry__._unsharded_oracle``): the
    blanker, the complex mix and band-pass, SSB / AM / SAM, [LMS notch], AGC,
    PBT, [spectral subtraction | LMS denoise x1.1]. Returns (audio, the
    spectral stage's input L and R scaled by the output gain, or None)."""
    from radiodsp_sdr_rx_tpu_torch.ops import (
        agc, demod, fastconv, iir, lms, nco, noise_blanker, planar)

    if nb:
        iq, _ = noise_blanker.noise_blanker(iq, st.nb_avg)
    z, _ = nco.nco_mix(iq, st.nco_phase, incs)
    z, _ = fastconv.overlap_save_filter(z, p.w_sideband, st.sb_tail)
    if mode == "usb":
        audio = demod.demod_ssb(z)
    elif mode == "am":
        audio, _ = iir.dc_blocker(z.abs(), st.am_dc)
    else:
        audio, _ = planar.demod_sam_planar(
            z.real.contiguous(), z.imag.contiguous(),
            planar.SAMStatePlanar(st.sam_phase, st.sam_freq, st.am_dc), sample_rate=FS)
    if nr == "notch":
        audio, _ = lms.lms_nr_run(audio, st.lms, mu, "notch")
    env, _ = agc.agc_envelope(audio.abs(), st.agc_env, p.agc_release)
    audio = audio * torch.clamp(p.agc_target / env.clamp(min=1e-12), max=p.agc_max_gain)
    za, _ = fastconv.overlap_save_filter(torch.complex(audio, audio), p.w_audio, st.audio_tail)
    audio, spec_in = za.real * p.output_gain, None
    if nr == "spectral":
        spec_in = (audio, za.imag * p.output_gain)
        audio = planar.spectral_subtract_planar(*spec_in, 30.0, st.nfloor, p.dft_cos, p.dft_sin,
                                                st.spec_tail_l, st.spec_tail_r)[0]
    if nr == "lms":
        audio = lms.lms_nr_run(audio, st.lms, mu, "denoise")[0] * 1.1
    return audio, spec_in


def sharded_paths(gen, reset_counts, counts, only, launches, err, timing) -> None:
    """7. the sharded paths on one card: K9 alone, the time-sharded chains
    with the kernel halo, the full 2-D chain, the sharded fused bank, and
    the vmap ReceiverBank past 128 LMS channels (fault F1). Adds K9's
    record to ``timing`` and prints the paths' times."""
    path_ms = {}
    from radiodsp_sdr_rx_tpu_torch.models.config import (
        AGCMode, DemodMode, NRMode, ReceiverConfig)
    from radiodsp_sdr_rx_tpu_torch.models.fused import FusedSSBBank
    from radiodsp_sdr_rx_tpu_torch.models.receiver import Receiver, ReceiverBank, build_params
    from radiodsp_sdr_rx_tpu_torch.ops import sweep
    from radiodsp_sdr_rx_tpu_torch.ops.spectral_sub import spectral_matmul_ops
    from radiodsp_sdr_rx_tpu_torch.parallel import (
        ShardedFusedBank, halo, make_mesh, make_time_sharded_ssb_chain)
    from radiodsp_sdr_rx_tpu_torch.parallel.stream_shard import (
        make_full_sharded_chain, sharded_chain_init)
    from radiodsp_sdr_rx_tpu_torch.utils import siggen

    def card(n):
        return make_mesh(channel=1, time=n, devices=[torch.device("cuda:0")] * n)

    # 7a. K9 alone: rings of 2, 4, 8 shards on cuda:0, bit for bit, one launch each
    for shards in (2, 4, 8):
        for shape in ((1, 128), (128, 128)):
            for dtype in (torch.float32, torch.complex64):
                blocks = [torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
                          for _ in range(shards)]
                first = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
                before = halo.LAUNCHES
                got = halo.ring_shift_right(blocks) + halo.shift_from_left_kernel(blocks, first)
                torch.cuda.synchronize()
                want = halo.ring_shift_right_plain(blocks) + halo.shift_from_left_plain(blocks,
                                                                                      first)
                same = all(torch.equal(g, w) for g, w in zip(got, want))
                check(same and halo.LAUNCHES - before == 2,
                      f"ring_shift {shards} x {shape} {dtype}: equal {same}, launches "
                      f"{halo.LAUNCHES - before} for 2 exchanges")
    say("check ring_shift (K9) vs plain: rings of 2, 4, 8 shards on cuda:0, blocks (1, 128) "
        "and (128, 128), f32 and complex64, ring_shift_right and shift_from_left: bit for "
        "bit, one launch per exchange")
    err["ring_shift"] = 0.0

    # 7b. the time-sharded chains at full width: a 2^21-sample stream on time=4
    n_1d = 1 << 21
    audio_in = siggen.voice_like(n_1d, FS)
    iq_usb = siggen.ssb_from_audio(audio_in, 10_000.0, FS, "usb", amp=0.4).astype(np.complex64)
    iq_am = siggen.am_signal(n_1d, 10_000.0, mod_hz=900.0, fs=FS).astype(np.complex64)
    kw = dict(vfo_freq=7_060_000.0, capture_center_freq=7_050_000.0, iq_gain_balance=1.0)
    ring_calls, launched = 0, dict.fromkeys(counts(), 0)
    for am, iq1, agc_mode in ((False, iq_usb, AGCMode.FAST), (True, iq_am, AGCMode.MEDIUM)):
        cfg1 = ReceiverConfig(mode=DemodMode.AM if am else DemodMode.USB, agc=agc_mode, **kw)
        p = build_params(cfg1)
        args = (p.nco_inc, p.w_sideband, p.w_audio, p.agc_release, p.agc_target,
                p.agc_max_gain, p.output_gain)
        iq_dev = torch.from_numpy(iq1).cuda()
        chains = {h: make_time_sharded_ssb_chain(card(4), am=am, sample_rate=FS, halo=h)
                  for h in ("kernel", "ppermute")}
        reset_counts()
        got = chains["kernel"](iq_dev, *args)
        torch.cuda.synchronize()
        launched = {k: v + launched[k] for k, v in counts().items()}
        ring_calls += 1
        ref = chains["ppermute"](iq_dev, *args)
        rx = Receiver(cfg1)
        single = rx.process(iq1, rx.init_state())[0]["audio_l"]
        torch.cuda.synchronize()
        d = float((got - single).abs().max())
        label = "AM" if am else "USB"
        say(f"check time-sharded {label} chain, 1 stream x {n_1d} on time=4 (cuda:0 x 4): "
            f"kernel halo vs ppermute bit for bit {bool(torch.equal(got, ref))}; max |sharded "
            f"- unsharded Receiver| = {d:.3e} (tolerance {TOL_PARITY:g}); rms "
            f"{float(got.square().mean().sqrt()):.4f}")
        check(torch.equal(got, ref), f"the kernel halo differs from the ppermute ({label})")
        check(d <= TOL_PARITY and bool(torch.isfinite(got).all()),
              f"the time-sharded {label} chain differs from the Receiver: {d:.3e}")
        path_ms[f"time-sharded {label} chain, kernel halo (1 x {n_1d}, time=4)"] = time_ms(
            lambda: chains["kernel"](iq_dev, *args), 3)
        path_ms[f"time-sharded {label} chain, ppermute halo (1 x {n_1d}, time=4)"] = time_ms(
            lambda: chains["ppermute"](iq_dev, *args), 3)
    launches["ring_shift"] += launched["ring_shift"]
    check(launched == only(ring_shift=2 * ring_calls), f"the kernel-halo chains launched "
          f"{launched}, expected 2 ring_shift per call ({ring_calls} calls) and no other")
    say(f"time-sharded chains, kernel halo: kernel launches {launched}")
    del iq_usb, iq_am, audio_in, iq_dev, got, ref, single

    # 7c. the full 2-D chain on channel=2 x time=4 over cuda:0
    mesh24 = make_mesh(channel=2, time=4, devices=[torch.device("cuda:0")] * 8)
    cfg2 = ReceiverConfig(mode=DemodMode.USB, agc=AGCMode.FAST, vfo_freq=7_200_000.0,
                          capture_center_freq=7_190_000.0, iq_gain_balance=1.0)
    p2 = build_params(cfg2)
    oracle_params = ReceiverBank(cfg2, [7_190_000.0]).params   # on the card, 0-d as floats
    args2 = (p2.w_sideband, p2.w_audio, p2.agc_release, p2.agc_target, p2.agc_max_gain,
             p2.agc_enabled, p2.output_gain)
    mu = 0.0316

    def run_full(mode, nr, nb, c, n, unbroken):
        """Segment 1 of two threaded ones (launches counted), the unsharded
        chain on it, and with ``unbroken`` max |split - unbroken run|."""
        incs = torch.tensor([(k * 977 + 12345) * 65536 % (1 << 32) for k in range(c)],
                            device="cuda")   # __graft_entry__.dryrun_multichip's
        xr, xi, _ = locked_scene(c, 2 * n, gen, [float(i) * FS / 2 ** 32 for i in incs],
                                 impulses=nb)
        iq = torch.complex(xr, xi)
        del xr, xi
        chain = make_full_sharded_chain(mesh24, mode=mode, nr=nr, sample_rate=FS, lms_mu=mu,
                                        nr_level=30.0, noise_blanker=nb)
        st0 = sharded_chain_init(c, device="cuda")
        full = chain(iq, incs, st0, *args2)[0] if unbroken else None
        reset_counts()
        a1, st1 = chain(iq[:, :n], incs, st0, *args2)
        a2, _ = chain(iq[:, n:], incs, st1, *args2)
        torch.cuda.synchronize()
        launched = counts()
        want, spec_in = unsharded_full_chain(mode, nr, nb, iq[:, :n], incs, oracle_params,
                                             st0, mu)
        split = torch.cat([a1, a2], dim=1)
        seam = 0.0 if full is None else float((split - full).abs().max())
        return a1, want, spec_in, seam, launched, chain, (iq, incs, st0)

    combos = [(m, r, False) for m in ("usb", "am", "sam")
              for r in ("off", "lms", "notch", "spectral")]
    combos += [("usb", "off", True), ("usb", "lms", True), ("sam", "off", True)]
    worst = 0.0
    n_dry = 2048 * 4
    t = time.perf_counter()
    for mode, nr, nb in combos:
        a1, want, _, seam, launched, *_ = run_full(mode, nr, nb, 8, n_dry, True)
        d = float((a1 - want).abs().max())
        tag = f"{nr}{'+nb' if nb else ''}"
        say(f"check full sharded chain {mode}/{tag}, 8 ch x 2 x {n_dry} on channel=2 x time=4 "
            f"(cuda:0 x 8): max |sharded - unsharded| = {d:.3e}, max |split - unbroken| = "
            f"{seam:.3e} (tolerance {TOL_PARITY:g}); launches {launched}")
        k3 = 2 if nr in ("lms", "notch") else 0   # one a segment: every line's sub-banks at once
        check(launched == only(lms_nr=k3), f"{mode}/{tag}: launches {launched}")
        check(d <= TOL_PARITY and seam <= TOL_PARITY and bool(torch.isfinite(a1).all()),
              f"the full sharded chain {mode}/{tag} is off: {d:.3e}, seam {seam:.3e}")
        worst = max(worst, d, seam)
    say(f"full sharded chain: {len(combos)} combos in {time.perf_counter() - t:.2f} s, worst "
        f"diff {worst:.3e}")
    for nr in ("lms", "spectral"):
        c, n = N_CHANNELS, SEG_LEN
        a1, want, spec_in, _, launched, chain, (iq, incs, st0) = run_full(
            "usb", nr, False, c, n, False)
        if nr == "spectral":
            # frames with a bin within rounding of the floor may flip (spectral_diff)
            w_fwd = torch.from_numpy(spectral_matmul_ops(256)[0]).cuda()
            _, _, mag, nfl = sweep.spectral_floor(*spec_in, w_fwd, st0.nfloor, st0.spec_tail_l,
                                                  st0.spec_tail_r, 30.0)
            nf = nfl.clamp(min=0.0)
            near = ((mag - nf[..., None]).abs() <= FLIP_MARGIN * nf[..., None]).sum(-1)
            d, n_near, n_moved, ok = spectral_diff((a1,), (want,), near, nf, 1.0, TOL_PARITY)
            detail = f"{d:.3e} over frames with no bin near the floor ({n_near} frames with " \
                     f"one, {n_moved} of them beyond {TOL_PARITY:g})"
        else:
            d = float((a1 - want).abs().max())
            ok, detail = d <= TOL_PARITY, f"{d:.3e}"
        say(f"check full sharded chain usb/{nr}, {c} ch x 2 x {n} on channel=2 x time=4: max "
            f"|sharded - unsharded| {detail} (tolerance {TOL_PARITY:g}); launches {launched}")
        check(launched == only(lms_nr=2 if nr == "lms" else 0),
              f"usb/{nr} full width: launches {launched}")
        check(ok and bool(torch.isfinite(a1).all()), f"usb/{nr} full width is off: {detail}")
        if nr == "lms":
            launches["lms_nr"] += launched["lms_nr"]
        x = iq[:, :n]
        path_ms[f"full sharded chain usb/{nr} ({c} ch x {n}, channel=2 x time=4)"] = time_ms(
            lambda: chain(x, incs, st0, *args2), 2)
        del a1, want, spec_in, iq, x
    # 7d. ShardedFusedBank of FusedSSBBank, 1,024 ch x 2^17 on channel=8, two segments
    c, n = 1024, 1 << 17
    cfg_b = ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_200_000.0,
                           capture_center_freq=7_190_000.0, agc=AGCMode.MEDIUM)
    freqs_b = [7_100_000.0 + 200.0 * k for k in range(c)]
    sharded = ShardedFusedBank(cfg_b, freqs_b, make_mesh(
        channel=8, devices=[torch.device("cuda:0")] * 8))
    one = FusedSSBBank(cfg_b, freqs_b)
    st_s, st_o = sharded.init_state(), one.init_state()
    same, launched = True, dict.fromkeys(counts(), 0)
    for seg in range(2):
        xr, xi = noise((c, n), gen), noise((c, n), gen)
        reset_counts()
        got, st_s = sharded.process_planar(xr, xi, st_s)
        launched = {k: v + launched[k] for k, v in counts().items()}
        want, st_o = one.process_planar(xr, xi, st_o)
        same &= all(torch.equal(got[k], want[k]) for k in got) and all(
            torch.equal(a, b) for a, b in zip(st_s, st_o))
    torch.cuda.synchronize()
    say(f"check ShardedFusedBank(FusedSSBBank), {c} ch x 2 x {n} on channel=8 (cuda:0 x 8): "
        f"equal to the unsharded bank bit for bit, output and state: {same}; launches of the "
        f"sharded bank {launched}")
    check(same, "the sharded fused bank differs from the unsharded one")
    check(launched == only(sweep_chain_ssb=16), f"ShardedFusedBank launches {launched}")
    launches["sweep_chain_ssb"] += launched["sweep_chain_ssb"]
    path_ms[f"ShardedFusedBank(FusedSSBBank) ({c} ch x {n}, channel=8)"] = time_ms(
        lambda: sharded.process_planar(xr, xi, st_s), 3)
    path_ms[f"FusedSSBBank ({c} ch x {n}, one bank)"] = time_ms(
        lambda: one.process_planar(xr, xi, st_o), 3)
    del sharded, one, xr, xi, got, want

    # 7e. fault F1: ReceiverBank(backend="vmap") with DNR2 past 128 channels
    cfg_f1 = cfg_b.with_(nr=NRMode.DNR2)
    c, n = 129, 1 << 16
    xr, xi = noise((c, n), gen), noise((c, n), gen)
    bank_f1 = ReceiverBank(cfg_f1, freqs_b[:c])
    reset_counts()
    got, _ = bank_f1.process_planar(xr, xi, bank_f1.init_state())
    launched = counts()
    parts = [ReceiverBank(cfg_f1, freqs_b[a:b], backend="batched") for a, b in ((0, 64),
                                                                                  (64, c))]
    want = torch.cat([b.process_planar(xr[s], xi[s], b.init_state())[0]["audio_l"]
                      for b, s in zip(parts, (slice(0, 64), slice(64, c)))])
    d = float((got["audio_l"] - want).abs().max())
    say(f"check ReceiverBank(backend='vmap') USB + DNR2 at {c} channels x {n}: max |vmap - "
        f"two batched banks of 64 and 65| = {d:.3e} (tolerance {TOL_LMS:g}); launches "
        f"{launched}")
    check(d <= TOL_LMS and launched == only(lms_nr=1), f"F1: {d:.3e}, launches {launched}")

    # 7f. K9 timed: a chain of 100 exchanges, 4 shards of (128, 128) complex64
    blocks = [torch.randn((128, 128), generator=gen, device="cuda", dtype=torch.complex64)
              for _ in range(4)]
    bufs = [torch.empty_like(b) for b in blocks]
    nbytes = 2 * sum(b.numel() * 8 for b in blocks)

    def chain_of(fn, k=100):
        def run():
            x = blocks
            for _ in range(k):
                x = fn(x)
        return run

    def copies(x):
        for s, buf in enumerate(bufs):
            buf.copy_(x[s - 1])
        return bufs

    b_ms, b_by = bound(0, nbytes)
    timing["ring_shift"] = dict(
        ms=time_ms(chain_of(halo.ring_shift_right), 3) / 100,
        plain_ms=time_ms(chain_of(halo.ring_shift_right_plain), 3) / 100,
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(chain_of(copies), 3) / 100,
        flops=0, samples=4 * 128 * 128, plain_from=4 * 128 * 128)
    busy = {}   # the device's own time per exchange, from a profiler trace
    for name, fn in (("kernel", halo.ring_shift_right), ("library", copies)):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            chain_of(fn)()
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy[name] = (sum(e.time_range.elapsed_us() for e in ops) / 100, len(ops) / 100)
    tm = timing["ring_shift"]
    say(f"timing ring_shift (K9), 4 shards of (128, 128) complex64 on cuda:0, a chain of 100 "
        f"exchanges: kernel {tm['ms'] * 1e3:.2f} us per exchange (one launch), plain (4 "
        f"copies) {tm['plain_ms'] * 1e3:.2f} us, library (4 copy_ into buffers) "
        f"{tm['library_ms'] * 1e3:.2f} us, bound {tm['bound_ms'] * 1e3:.3f} us ({b_by}, "
        f"{nbytes} B); device busy per exchange by the profiler: kernel "
        f"{busy['kernel'][0]:.2f} us in {busy['kernel'][1]:.0f} operation(s), library "
        f"{busy['library'][0]:.2f} us in {busy['library'][1]:.0f}")
    say("timing sharded paths: " + "; ".join(f"{k} {v:.3f} ms" for k, v in path_ms.items()))


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
    from radiodsp_sdr_rx_tpu_torch.models.receiver import Receiver, ReceiverBank
    from radiodsp_sdr_rx_tpu_torch.ops import (
        agc, fir_design, iir, lanes, lms, lms_bank, nco, planar, sam, sam_wide, staged, sweep,
        sweep_spec)
    from radiodsp_sdr_rx_tpu_torch.ops.operators import ssb_demod_operator
    from radiodsp_sdr_rx_tpu_torch.parallel import halo
    from radiodsp_sdr_rx_tpu_torch.utils import scenes, siggen
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
        sweep.LAUNCHES_SWEEP_MIX = 0
        halo.LAUNCHES = 0

    def counts() -> dict:
        return {"sweep_chain_ssb": sweep.LAUNCHES, "sweep_chain_ssb_nb": sweep.LAUNCHES_NB,
                "mix_demod": staged.LAUNCHES_MIX_DEMOD, "pbt": staged.LAUNCHES_PBT,
                "sweep_chain_am": sweep.LAUNCHES_AM, "sweep_chain_am_nb": sweep.LAUNCHES_AM_NB,
                "lms_nr": lms_bank.LAUNCHES, "sweep_chain_ssb_mono": sweep.LAUNCHES_MONO,
                "sweep_spec_chain": sweep_spec.LAUNCHES, "sam_pll": sam.LAUNCHES,
                "sweep_chain_sam": sweep.LAUNCHES_SAM, "sweep_chain_sam_nb": sweep.LAUNCHES_SAM_NB,
                "sam_wide": sam_wide.LAUNCHES, "sam_wide_nb": sam_wide.LAUNCHES_NB,
                **lanes.LAUNCHES, "sweep_mix_demod": sweep.LAUNCHES_SWEEP_MIX,
                "ring_shift": halo.LAUNCHES}

    def only(**launched) -> dict:
        """The counts of a path that launched these kernels and no other."""
        return {k: launched.get(k, 0) for k in counts()}

    # 2. the kernel builds, one nvcc per source, all at once
    t = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES) + 1) as pool:
        latency_lib = pool.submit(build_latency_probe)
        list(pool.map(build.load_library, LIBRARIES))
        latency_lib = latency_lib.result()
    say(f"build: csrc/{{{','.join(LIBRARIES)}}}.cu and the latency chains with nvcc for "
        f"sm_90a in {time.perf_counter() - t:.2f} s")
    ptxas = {}
    for lib in LIBRARIES:
        for kname, regs, spills in ptxas_summary(build.build_log(lib)):
            say(f"ptxas {lib}.cu {kname}: {regs}; {spills}")
            ptxas[kname] = f"{regs}; {spills}"

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
    # the LMS stage's arguments are recorded, and the plain LMS (the grouped
    # algebra, a few tensor calls per group of 16 samples) runs over the same
    # three segments' inputs with its own state threaded from the first: the
    # LMS's input does not depend on its output, so every segment's output
    # and the state after each are held to the kernel's
    cfg3 = ReceiverConfig(mode=DemodMode.CW_NARROW, vfo_freq=14_050_000.0,
                          capture_center_freq=14_049_000.0, agc=AGCMode.FAST,
                          nr=NRMode.NOTCH)
    cfg7 = cfg.with_(nr=NRMode.DNR2)
    lms_args, lms_plain_ms = {}, {}
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
        lms_args[label] = recorded[1][0]
        (_, w, win, dl, first, mu_rb, mode), _ = recorded[0]
        d = 0.0
        for seg, ((x, *_), got) in enumerate(recorded):
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            ref = lms_bank.lms_nr_run_bank_plain(x, w, win, dl, first, mu_rb, mode)
            t1.record()
            t1.synchronize()
            if seg == 1:
                lms_plain_ms[label] = t0.elapsed_time(t1)
            d = max(d, max_diff(got, ref))
            _, w, win, dl = ref
            first = torch.zeros_like(first)
        say(f"check lms_nr ({mode}) full width: max |kernel - plain| over out, weights, window "
            f"and delay of {SEGMENTS} whole threaded segments = {d:.3e} (tolerance "
            f"{TOL_LMS:g}); rms(L) = {float(out_1['audio_l'].square().mean().sqrt()):.4e}")
        check(d <= TOL_LMS, f"lms_nr disagrees at full width: {d:.3e} > {TOL_LMS:g}")
        err["lms_nr"] = max(err["lms_nr"], d)
        ends[label] = (rb, xr, xi, state_rb)
        del out_1, ref, got, recorded[:], x

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

    # the step's pieces (csrc/sam.cu sam_probe; no launch counted): the
    # explicit divide against numpy's float32 division over the PLL's
    # operands (tiny numerators and quotients near the subnormal grid's
    # midpoints included), bit for bit where the quotient is at least 2^-126,
    # within 2^-149 below, a zero numerator's signed zero (div_rn's
    # contract), the compiler's `/` and torch's division bit for bit
    # everywhere; the atan2 within ATAN2_ULPS of the plain version
    num, den = sam.probe_operands(29)
    a_dev, b_dev = torch.from_numpy(num).cuda(), torch.from_numpy(den).cuda()
    q, q_ref, _ = sam.probe(a_dev, b_dev)
    want = num / den
    sub = np.abs(want) < np.float32(2.0 ** -126)
    bits = [t.cpu().numpy() for t in (q, q_ref, a_dev / b_dev)]
    same = [int((t.view(np.int32) != want.view(np.int32))[~sub].sum()) for t in bits]
    same_sub = [int((t.view(np.int32) != want.view(np.int32))[sub].sum()) for t in bits]
    sub_err = float(np.abs(bits[0][sub].astype(np.float64) - want[sub]).max())
    zero = num == 0
    zero_sign = int((np.signbit(bits[0][zero]) != np.signbit(want[zero])).sum())
    y = torch.randn(1 << 18, generator=gen, device="cuda")
    x = torch.randn(1 << 18, generator=gen, device="cuda")
    y[:4096] = x[:4096] * torch.where(torch.rand(4096, generator=gen, device="cuda") < 0.5, -1, 1)
    y[4096:8192] = x[4096:8192] * np.float32(0.41421356)
    y[:8], x[:8] = (torch.tensor(v, dtype=torch.float32, device="cuda") for v in (
        [0, 1, -1, 0, 0, 1, -1, 0], [0, 0, 0, 1, -1, 1, -1, -1]))
    t_dev = sam.probe(y, x)[2].cpu().numpy()
    t_plain = sam.atan2_poly(y.cpu(), x.cpu()).numpy()
    ulps = float((np.abs(t_dev.astype(np.float64) - t_plain)
                  / np.spacing(np.abs(t_plain).astype(np.float32))).max())
    say(f"check the PLL step's pieces (sam_probe): div_rn, the compiler's `/` and torch's "
        f"division vs numpy's float32 division over {num.size} operands (den 1e-30..2^24, "
        f"|num| <= den, subnormal numerators included): {same} differ of the "
        f"{int((~sub).sum())} quotients >= 2^-126, {same_sub} of the {int(sub.sum())} below "
        f"(div_rn within {sub_err / 2.0 ** -149:g} x 2^-149 there, bound 1; the sign of "
        f"{int(zero.sum())} zero numerators' quotients kept but {zero_sign}); atan2_poly vs "
        f"plain over {y.numel()} inputs: {ulps:.1f} ulps (bound {ATAN2_ULPS})")
    check(same == [0, 0, 0] and same_sub[1:] == [0, 0] and sub_err <= 2.0 ** -149
          and zero_sign == 0,
          "div_rn or `/` departs from IEEE division on the PLL's operands")
    check(ulps <= ATAN2_ULPS, f"the device atan2 is {ulps:.1f} ulps from the plain one")
    del q, q_ref, a_dev, b_dev, y, x

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
    # the long run: K5 and sweep_chain_sam over SAM_LONG samples as two
    # threaded segments at full width, against their plain versions on the CPU
    # copy of SAM_LONG_ROWS channels spread over the bank (the plain loop is
    # one step per sample; 32 K5 re-seed periods, 128 of K6)
    rows_l = list(range(0, c6, c6 // SAM_LONG_ROWS))
    half_l = SAM_LONG // 2
    t = time.perf_counter()
    (zr, zi, ph0, fr0, bw, fs, chunk), _ = bank6s.pll_args(
        xr6[:, :SAM_LONG].contiguous(), xi6[:, :SAM_LONG].contiguous(), bank6s.init_state())
    got, ph, fr = [], ph0, fr0
    for h in range(2):
        vr_h, ph, fr = sam.sam_pll_run(zr[:, h * half_l:(h + 1) * half_l].contiguous(),
                                       zi[:, h * half_l:(h + 1) * half_l].contiguous(), ph, fr,
                                       bw, fs, chunk)
        got.append(vr_h[rows_l].cpu())
    ref = sam.sam_pll_run_plain(zr[rows_l].cpu(), zi[rows_l].cpu(), ph0[rows_l].cpu(),
                                fr0[rows_l].cpu(), bw, fs, chunk)
    d_k5 = max(max_diff([torch.cat(got, 1), fr[rows_l].cpu()], [ref[0], ref[2]]),
               phase_diff(ph[rows_l].cpu(), ref[1]))
    say(f"check sam_pll long run: {len(rows_l)} of {c6} ch (rows {rows_l}) x {SAM_LONG} "
        f"samples as 2 threaded segments, the plain loop on the CPU in "
        f"{time.perf_counter() - t:.1f} s: max |kernel - plain| over vr, phase (wrap-aware), "
        f"freq = {d_k5:.3e} (tolerance {TOL:g})")
    check(d_k5 <= TOL, f"sam_pll disagrees with the plain version over the long run: {d_k5:.3e}")
    del zr, zi, got, ref
    t = time.perf_counter()
    bank_h = FusedSAMBank(cfg_sam, [freqs10[k] for k in rows_l], device="cpu")
    st_k, st_h, d_k6 = bank6.init_state(), bank_h.init_state(), 0.0
    for h in range(2):
        xs = (xr6[:, h * half_l:(h + 1) * half_l].contiguous(),
              xi6[:, h * half_l:(h + 1) * half_l].contiguous())
        out_k, st_k = bank6.process_planar(*xs, st_k)
        out_h, st_h = bank_h.process_planar(*(x[rows_l].cpu() for x in xs), st_h)
        d_k6 = max(d_k6, max_diff([out_k[k][rows_l].cpu() for k in ("audio_l", "audio_r")]
                                  + [st_k.sam_freq[rows_l].cpu(), st_k.sam_dc[rows_l].cpu(),
                                     st_k.agc_env[rows_l].cpu()],
                                  [out_h["audio_l"], out_h["audio_r"], st_h.sam_freq[:len(rows_l)],
                                   st_h.sam_dc, st_h.agc_env]),
                   phase_diff(st_k.sam_phase[rows_l].cpu(), st_h.sam_phase[:len(rows_l)]))
    say(f"check sweep_chain_sam long run: {len(rows_l)} of {c6} ch x {SAM_LONG} samples as 2 "
        f"threaded segments, the plain chain on the CPU in {time.perf_counter() - t:.1f} s: max "
        f"|kernel - plain| over L, R, sam_freq, sam_dc, env, sam_phase (wrap-aware) = "
        f"{d_k6:.3e} (tolerance {TOL:g})")
    check(d_k6 <= TOL, f"sweep_chain_sam disagrees with the plain chain over the long run: "
          f"{d_k6:.3e}")
    err["sam_pll"] = max(err["sam_pll"], d_k5)
    err["sweep_chain_sam"] = max(err["sweep_chain_sam"], d_k6)
    del out_k, out_h, st_k, st_h, bank_h
    xr6nb, xi6nb, mean6 = locked_scene(c6, SEG_LEN, gen, nco10[:c6], impulses=True)
    bank6nb = FusedSAMBank(cfg_sam_nb, freqs10[:c6])
    st0 = bank6nb.init_state()._replace(nb_avg=torch.full((c6,), mean6, device="cuda"))
    sam_ends["sweep_chain_sam_nb"] = (bank6nb, xr6nb, xi6nb, sam_kernel_checks(
        "sweep_chain_sam_nb", bank6nb, xr6nb, xi6nb, st0, "SAM config6 fold=True + blanker",
        SEG_LEN))

    check(SAM_LONG <= SEG_WIDE, "the long runs take config10's and the NR routes' scenes")
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
    # the long run of K7: config10's bank over SAM_LONG samples as two threaded
    # segments, its first and last blocks (16 channels, G = 8) against the
    # plain chain on the CPU on K7's re-seed schedule (16 channels alone
    # would take K6's)
    rows_w = list(range(8)) + list(range(N_SAM_WIDE - 8, N_SAM_WIDE))
    t = time.perf_counter()
    bank_h = FusedSAMBank(cfg_sam, [freqs10[k] for k in rows_w], device="cpu")
    bank_h.reseed_schedule = bank10.reseed_schedule
    st_k, st_h, d_k7 = bank10.init_state(), bank_h.init_state(), 0.0
    for h in range(2):
        xs = (xr10[:, h * half_l:(h + 1) * half_l].contiguous(),
              xi10[:, h * half_l:(h + 1) * half_l].contiguous())
        out_k, st_k = bank10.process_planar(*xs, st_k)
        out_h, st_h = bank_h.process_planar(*(x[rows_w].cpu() for x in xs), st_h)
        d_k7 = max(d_k7, max_diff([out_k[k][rows_w].cpu() for k in ("audio_l", "audio_r")]
                                  + [st_k.sam_freq[rows_w].cpu(), st_k.sam_dc[rows_w].cpu(),
                                     st_k.agc_env[rows_w].cpu(), st_k.audio_tail[rows_w].cpu()],
                                  [out_h["audio_l"], out_h["audio_r"], st_h.sam_freq[:len(rows_w)],
                                   st_h.sam_dc, st_h.agc_env, st_h.audio_tail]),
                   phase_diff(st_k.sam_phase[rows_w].cpu(), st_h.sam_phase[:len(rows_w)]))
    say(f"check sam_wide long run: {len(rows_w)} of {N_SAM_WIDE} ch (blocks 0 and "
        f"{N_SAM_WIDE // 8 - 1}, G = 8) x {SAM_LONG} samples as 2 threaded segments, the plain "
        f"chain on the CPU in {time.perf_counter() - t:.1f} s: max |kernel - plain| over L, R, "
        f"sam_freq, sam_dc, env, audio_tail, sam_phase (wrap-aware) = {d_k7:.3e} (tolerance "
        f"{TOL:g})")
    check(d_k7 <= TOL, f"sam_wide disagrees with the plain chain over the long run: {d_k7:.3e}")
    err["sam_wide"] = max(err["sam_wide"], d_k7)
    del out_k, out_h, st_k, st_h, bank_h

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
    # segment, PERF.md section 4), two threaded segments. Each kernel is held
    # to its plain chain over the whole segment (the plain LMS is the grouped
    # algebra; with SAM on a SAM_PREFIX-sample prefix, the plain PLL being a
    # host-bound loop of one step per sample): as two threaded segments of
    # half of it, every carry compared, and as the full run's segment 1
    # (the chain is causal). Spectral NR is compared frame by
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
        prefix = SAM_PREFIX if bank.demod == "sam" else seg_len
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

    # the long run of SAM + spectral: the 128-channel bank over SAM_LONG
    # samples as two threaded segments, SAM_LONG_ROWS channels spread over it
    # against the plain chain on the CPU, frame by frame (spectral_diff)
    margins = []

    def plain_spectral(*args):
        """lanes.sweep_lanes_chain_plain on SAM + spectral arguments, and each
        frame's bins near the plain floor (floor_margins) into margins, from
        one pass of the per-sample plain PLL."""
        *chain, dc0, sam_a, _, spec = args
        og = float(np.float32(chain[14]))
        chain[14] = 1.0   # the spectral stage sees [l | r] before the output gain
        l, r, *carries = sweep.chain_plain(*chain, dc0, sam=sam_a)
        _, _, mag, nfloor = sweep.spectral_floor(l, r, spec.w_fwd, spec.nfloor0, spec.tail_l,
                                                 spec.tail_r, spec.nr_level)
        nf = nfloor.clamp(min=0.0)
        margins.append((((mag - nf[..., None]).abs() <= FLIP_MARGIN * nf[..., None]).sum(-1),
                        nf))
        yl, yr, *spec_out = sweep.spectral_plain(l, r, spec)
        return lanes.LanesOut(yl * og, yr * og, *carries[:4], None, None, None, *spec_out,
                              *(carries[4:] or (None, None)))

    b_s, x_r, x_i, _ = nr_ends["lanes_sam_spectral"]
    check(x_r.shape[1] >= SAM_LONG, "the SAM + spectral scene covers the long run")
    rows_s = list(range(0, N_CHANNELS, N_CHANNELS // SAM_LONG_ROWS))
    t = time.perf_counter()
    bank_h = FusedNRBank(b_s.config, [bank_freqs["lanes_sam_spectral"][k] for k in rows_s],
                         device="cpu")
    st_k, st_h, d_sp, near_frames, sp_ok = b_s.init_state(), bank_h.init_state(), 0.0, 0, True
    for h in range(2):
        xs = (x_r[:, h * half_l:(h + 1) * half_l].contiguous(),
              x_i[:, h * half_l:(h + 1) * half_l].contiguous())
        out_k, st_k = b_s.process_planar(*xs, st_k)
        kernel_run, lanes.sweep_lanes_chain = lanes.sweep_lanes_chain, plain_spectral
        try:
            out_h, st_h = bank_h.process_planar(*(x[rows_s].cpu() for x in xs), st_h)
        finally:
            lanes.sweep_lanes_chain = kernel_run
        d, n_near, _, ok = spectral_diff(
            [out_k[k][rows_s].cpu() for k in ("audio_l", "audio_r")],
            [out_h["audio_l"], out_h["audio_r"]], *margins[-1], b_s.params.output_gain, TOL)
        d_sp, near_frames, sp_ok = max(d_sp, d), near_frames + n_near, sp_ok and ok
        c_s = len(rows_s)
        d_sp = max(d_sp, max_diff(
            [st_k.audio_tail[rows_s].cpu(), st_k.agc_env[rows_s].cpu(), st_k.dc[rows_s].cpu(),
             st_k.pll[1, rows_s].cpu(), st_k.nfloor[rows_s].cpu(),
             st_k.spec_tail_l[rows_s].cpu(), st_k.spec_tail_r[rows_s].cpu()],
            [st_h.audio_tail, st_h.agc_env, st_h.dc[:c_s], st_h.pll[1, :c_s], st_h.nfloor,
             st_h.spec_tail_l, st_h.spec_tail_r]),
            phase_diff(st_k.pll[0, rows_s].cpu(), st_h.pll[0, :c_s]))
    say(f"check lanes_sam_spectral long run: {len(rows_s)} of {N_CHANNELS} ch (rows {rows_s}) x "
        f"{SAM_LONG} samples as 2 threaded segments, the plain chain on the CPU in "
        f"{time.perf_counter() - t:.1f} s: max |kernel - plain| over the frames of L, R with no "
        f"bin near the floor and every carry (the PLL phase wrap-aware) = {d_sp:.3e} (tolerance "
        f"{TOL:g}); {near_frames} frames with a bin near the floor, all within the flip bound: "
        f"{sp_ok}")
    check(d_sp <= TOL and sp_ok, f"lanes_sam_spectral disagrees with the plain chain over the "
          f"long run: {d_sp:.3e}, or a frame outside its flip bound")
    err["lanes_sam_spectral"] = max(err["lanes_sam_spectral"], d_sp)
    del out_k, out_h, st_k, st_h, bank_h, margins

    # 4k. K8, sweep_mix_filter_demod, at tools/bench_sweep.py's shapes: 128 ch
    # x 2^19, the SSB operator of a 300-4000 Hz band, DDS increment
    # 123456789 from phase 0 on the main path's 0.1-sigma noise, driven as the
    # tool drives it (each call consumes the previous call's output), then
    # the same input with per-channel increments 1 kHz apart, random phases
    # and out_gain 1.1. Held to its plain version, to mix_demod with a zero
    # tail (its function from a stream start), across chunk_t, on an odd
    # chunk count and a single chunk
    w_k8 = torch.as_tensor(np.ascontiguousarray(ssb_demod_operator(
        fir_design.design_filter_mask(300.0, 4000.0, 44117.64706))), device="cuda")
    inc_k8 = torch.full((N_CHANNELS,), K8_INC, dtype=torch.int64, device="cuda")
    ph_k8 = torch.zeros(N_CHANNELS, dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    reset_counts()
    a, b = xr, xi
    for seg in range(SEGMENTS):
        o = sweep.sweep_mix_filter_demod(a, b, inc_k8, ph_k8, w_k8)
        if seg == 0:
            k8_first = o
        a, b = o, a
    torch.cuda.synchronize()
    launched = counts()
    for k, v in launched.items():
        launches[k] += v
    say(f"K8 path (tools/bench_sweep.py): {N_CHANNELS} ch x {SEG_LEN} samples, {SEGMENTS} "
        f"chained calls in {time.perf_counter() - t:.3f} s, kernel launches {launched}")
    check(launched == only(sweep_mix_demod=SEGMENTS), f"expected {SEGMENTS} sweep_mix_demod "
          f"launches and no other, counted {launched}")
    check(tuple(o.shape) == (N_CHANNELS, SEG_LEN) and bool(torch.isfinite(o).all()),
          "K8's output is not finite or has the wrong shape")
    del a, b, o
    inc_k8b = torch.tensor([int(nco.freq_to_phase_inc(1000.0 * k, 44117.64706))
                            for k in range(N_CHANNELS)], dtype=torch.int64, device="cuda")
    ph_k8b = torch.randint(0, 2**32, (N_CHANNELS,), generator=gen, device="cuda",
                           dtype=torch.int64)
    zero_tail = torch.zeros((N_CHANNELS, 256), device="cuda")
    for label, inc_, ph_, og in (("inc 123456789, gain 1.0", inc_k8, ph_k8, 1.0),
                                 ("increments 1 kHz apart, gain 1.1", inc_k8b, ph_k8b, 1.1)):
        got = k8_first if og == 1.0 else sweep.sweep_mix_filter_demod(xr, xi, inc_, ph_, w_k8,
                                                                       out_gain=og)
        d = max_diff([got], [sweep.sweep_mix_filter_demod_plain(xr, xi, inc_, ph_, w_k8, og)])
        d_k2a = max_diff([got], [staged.fused_mix_filter_demod(xr, xi, inc_, ph_, w_k8, zero_tail)
                                 * float(np.float32(og))])
        d_chunk = max(max_diff([sweep.sweep_mix_filter_demod(xr, xi, inc_, ph_, w_k8, og,
                                                             chunk_t=ct)], [got])
                      for ct in (2048, 8192))
        torch.cuda.synchronize()
        say(f"check sweep_mix_demod full width ({label}): max |kernel - plain| = {d:.3e} "
            f"(tolerance {TOL:g}); max |K8 - mix_demod with a zero tail| = {d_k2a:.3e} "
            f"(tolerance {TOL_K8_K2A:g}); across chunk_t 2048, 4096, 8192: {d_chunk:.3e} "
            f"(tolerance {TOL_CHUNK:g}); rms {float(got.square().mean().sqrt()):.4f}")
        check(d <= TOL and d_k2a <= TOL_K8_K2A and d_chunk <= TOL_CHUNK,
              f"sweep_mix_demod disagrees ({label}): plain {d:.3e}, mix_demod {d_k2a:.3e}, "
              f"chunk_t {d_chunk:.3e}")
        err["sweep_mix_demod"] = max(err["sweep_mix_demod"], d)
    del got, k8_first, zero_tail
    x6r, x6i = xr[:, :3 * 2048].contiguous(), xi[:, :3 * 2048].contiguous()
    want6 = sweep.sweep_mix_filter_demod_plain(x6r, x6i, inc_k8b, ph_k8b, w_k8)
    d6 = max(max_diff([sweep.sweep_mix_filter_demod(x6r, x6i, inc_k8b, ph_k8b, w_k8,
                                                    chunk_t=ct)], [want6])
             for ct in (2048, 3 * 2048))
    say(f"check sweep_mix_demod on 3 x 2048 samples (an odd chunk count, and one chunk): max "
        f"|kernel - plain| = {d6:.3e} (tolerance {TOL:g})")
    check(d6 <= TOL, f"sweep_mix_demod disagrees on an odd chunk count: {d6:.3e}")
    err["sweep_mix_demod"] = max(err["sweep_mix_demod"], d6)
    del x6r, x6i, want6

    # 4l. the single-channel Receiver (the model the CLI runs) on the card: the
    # six golden scenes, rebuilt by the port's utils/scenes.py, one call of
    # 65,536 samples each, held to tests/goldens/*.npz at 1e-4 x the golden's
    # peak (tests/test_golden_captures.py); the NOTCH case's LMS on K3
    for gname, g_cfg, g_iq, _ in scenes.golden_cases():
        rx = Receiver(g_cfg)
        st0 = rx.init_state()
        torch.cuda.synchronize()
        reset_counts()
        out, _ = rx.process(g_iq, st0)
        torch.cuda.synchronize()
        launched = counts()
        for k, v in launched.items():
            launches[k] += v
        lms_path = g_cfg.nr.kind in ("lms", "notch")
        check(launched == (only(lms_nr=1) if lms_path else only()),
              f"Receiver {gname}: launches {launched}")
        check(all(bool(torch.isfinite(v).all()) and v.shape == (len(g_iq),) for v in out.values()),
              f"Receiver {gname}: output not finite or of the wrong shape")
        want = np.load(GOLDENS / f"{gname}.npz")["audio_l"]
        peak = max(float(np.abs(want).max()), 1e-6)
        d = float(np.abs(out["audio_l"][:len(want)].cpu().numpy() - want).max())
        say(f"golden {gname} ({g_cfg.mode.name}, NR {g_cfg.nr.name}"
            f"{', blanker' if g_cfg.noise_blanker else ''}): Receiver on the card, "
            f"{len(g_iq)} samples, max |audio - golden| = {d / peak:.3e} x peak (bound 1e-4); "
            f"launches {dict((k, v) for k, v in launched.items() if v)}")
        check(d <= 1e-4 * peak, f"Receiver {gname} is off its golden: {d / peak:.3e} x peak")

    # 4m. the Receiver on the card against the Receiver on the CPU, two
    # threaded segments of CLI_BLOCK samples of the QRM scene: fft_length 512
    # with DNR2 (K3 on the card), conv_first, conv_first with the inline
    # denoise and SPEC2; then the I2S re-scoring: a USB voice scene whose Q is
    # one sample late from the middle of segment 2 of 8, hysteresis 3, the
    # sequence of locked repairs on both
    iq_q, truth_q = scenes.qrm_ssb_scene(2 * CLI_BLOCK)
    cfg_rx = ReceiverConfig(mode=DemodMode.USB, vfo_freq=truth_q["station_freq"],
                            capture_center_freq=truth_q["center"], agc=AGCMode.MEDIUM)
    for kw in ({"fft_length": 512, "nr": NRMode.DNR2}, {"conv_first": True},
               {"conv_first": True, "conv_inline_denoise": True, "nr": NRMode.SPEC2}):
        c_rx = cfg_rx.with_(**kw)
        on_card, on_cpu = Receiver(c_rx), Receiver(c_rx, device="cpu")
        st_c, st_h, d = on_card.init_state(), on_cpu.init_state(), 0.0
        tol = TOL_LMS if c_rx.nr.kind == "lms" else TOL
        reset_counts()
        for seg in range(2):
            part = iq_q[seg * CLI_BLOCK:(seg + 1) * CLI_BLOCK]
            out_c, st_c = on_card.process(part, st_c)
            out_h, st_h = on_cpu.process(part, st_h)
            d = max(d, max(float((out_c[k].cpu() - out_h[k]).abs().max()) for k in out_c))
        torch.cuda.synchronize()
        launched = counts()
        for k, v in launched.items():
            launches[k] += v
        check(launched == (only(lms_nr=2) if c_rx.nr.kind == "lms" else only()),
              f"Receiver {kw}: launches {launched}")
        say(f"check Receiver card vs CPU {dict((k, getattr(v, 'name', v)) for k, v in kw.items())}"
            f", 2 x {CLI_BLOCK}: max |card - cpu| over L, R = {d:.3e} (tolerance {tol:g})")
        check(d <= tol, f"the Receiver on the card disagrees with the CPU ({kw}): {d:.3e}")
    seg_i2s, n_i2s = 4096, 8 * 4096
    iq_v = siggen.ssb_from_audio(siggen.voice_like(n_i2s, FS), 10_000.0, FS, "usb", amp=0.4)
    iq_v = iq_v + siggen.noise(n_i2s, 0.01)
    q_late = iq_v.imag.copy()
    q_late[2 * seg_i2s + 1000:] = q_late[2 * seg_i2s + 999:-1]
    iq_v = (iq_v.real + 1j * q_late).astype(np.complex64)
    c_rx = ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_160_000.0,
                          capture_center_freq=7_150_000.0, auto_iq_repair=True)
    on_card, on_cpu = Receiver(c_rx), Receiver(c_rx, device="cpu")
    st_c, st_h, seq_c, seq_h, d = on_card.init_state(), on_cpu.init_state(), [], [], 0.0
    for k in range(8):
        part = iq_v[k * seg_i2s:(k + 1) * seg_i2s]
        out_c, st_c = on_card.process(part, st_c)
        out_h, st_h = on_cpu.process(part, st_h)
        seq_c.append(on_card.iq_repair_idx)
        seq_h.append(on_cpu.iq_repair_idx)
        d = max(d, float((out_c["audio_l"].cpu() - out_h["audio_l"]).abs().max()))
    say(f"check Receiver I2S repair, Q one sample late from mid segment 2 of 8, hysteresis "
        f"{c_rx.iq_repair_hysteresis}: locked repair per segment on the card {seq_c}, on the CPU "
        f"{seq_h}; max |card - cpu| over L = {d:.3e} (tolerance {TOL:g})")
    check(seq_c == seq_h and seq_c[-1] == 2 and seq_c[:4] == [0] * 4 and d <= TOL,
          "the I2S repair sequence on the card differs from the CPU's or from the slip")
    del iq_v, q_late, out_c, out_h

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

    def k8_chain():
        """tools/bench_sweep.py's timing: REPS calls, each on the previous output."""
        a, b = xr, xi
        for _ in range(REPS):
            o = sweep.sweep_mix_filter_demod(a, b, inc_k8, ph_k8, w_k8)
            a, b = o, a

    b_ms, b_by = bound(ops1, 3 * samples * 4 + 4 * 512 * 128 + N_CHANNELS * 2 * 8)
    timing["sweep_mix_demod"] = dict(
        ms=time_ms(k8_chain, 1) / REPS,
        plain_ms=time_ms(lambda: sweep.sweep_mix_filter_demod_plain(xr, xi, inc_k8, ph_k8, w_k8),
                         3),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib1_ms, flops=ops1, samples=samples)

    # the Receiver per CLI block: CLI_BLOCKS threaded blocks of CLI_BLOCK
    # samples of the QRM scene after one warm-up block, automatic I2S repair
    # on (the CLI's default: one int read back per block), the host clock
    # around the run; one channel, so every tensor is (1, n)
    iq_t, truth_t = scenes.qrm_ssb_scene((CLI_BLOCKS + 1) * CLI_BLOCK)
    rx_ms, rx_busy = {}, {}
    for nr_t in (NRMode.OFF, NRMode.NOTCH, NRMode.SPEC2):
        rx = Receiver(ReceiverConfig(mode=DemodMode.USB, vfo_freq=truth_t["station_freq"],
                                     capture_center_freq=truth_t["center"], nr=nr_t,
                                     auto_iq_repair=True))
        _, st = rx.process(iq_t[:CLI_BLOCK], rx.init_state())
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        for k in range(1, CLI_BLOCKS + 1):
            out, st = rx.process(iq_t[k * CLI_BLOCK:(k + 1) * CLI_BLOCK], st)
        torch.cuda.synchronize()
        rx_ms[nr_t.name] = (time.perf_counter() - t) * 1e3 / CLI_BLOCKS
        launched = counts()
        for k, v in launched.items():
            launches[k] += v
        check(launched == (only(lms_nr=CLI_BLOCKS) if nr_t == NRMode.NOTCH else only()),
              f"Receiver {nr_t.name} timing run: launches {launched}")
        check(bool(torch.isfinite(out["audio_l"]).all()), "Receiver output not finite")
        # the device's busy time in the same blocks, from a profiler trace of
        # PROFILED_BLOCKS more: the kernels' and copies' summed durations
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for k in range(1, PROFILED_BLOCKS + 1):
                out, st = rx.process(iq_t[k * CLI_BLOCK:(k + 1) * CLI_BLOCK], st)
            torch.cuda.synchronize()
        device_ops = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
        rx_busy[nr_t.name] = (sum(e.time_range.elapsed_us() for e in device_ops) / 1e3
                              / PROFILED_BLOCKS, len(device_ops) / PROFILED_BLOCKS)
    del iq_t, out

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

    # K4 at config4's shape (64 ch x 2^19); the library yardstick is the
    # chain's two products as fp32 torch.matmul and torch.fft.fft and ifft of
    # the stage's frames (rows, 256) complex
    samples4 = N_SPEC * SEG_LEN
    rows4 = samples4 // 128
    f1 = torch.randn((rows4, 512), generator=gen, device="cuda")
    f2 = torch.randn((rows4, 256), generator=gen, device="cuda")
    fz = torch.randn((rows4, 256), generator=gen, device="cuda", dtype=torch.complex64)
    lib_spec_ms = time_ms(lambda: (torch.matmul(f1, w_ssb), torch.matmul(f2, w_pbt),
                                   torch.fft.ifft(torch.fft.fft(fz))), REPS)
    del f1, f2, fz
    b4, x_r, x_i, st = ends["config4 fold=True"]
    args = b4.spec_args(x_r, x_i, st)
    spec_bytes = (4 * samples4 * 4 + 4 * (512 * 128 + 256 * 256)
                  + N_SPEC * (2 * 8 + 2 * 128 * 4 + 2 * 128 * 4 + 4 * 4 + 4 * 128 * 4))
    b_ms, b_by = bound(SPEC_FLOPS_PER_SAMPLE * samples4, spec_bytes + 4 * 512)
    dense_ms, _ = bound((2 * (512 * 128 + 256 * 256) + SPEC_DENSE_FLOPS_PER_ROW) * rows4,
                        spec_bytes + 4 * (512 * 512 + 512 * 256))
    timing["sweep_spec_chain"] = dict(
        ms=time_ms(lambda: sweep_spec.sweep_spec_chain(*args), REPS),
        plain_ms=time_ms(lambda: sweep_spec.sweep_spec_chain_plain(*args), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_spec_ms,
        flops=SPEC_FLOPS_PER_SAMPLE * samples4, samples=samples4, channels=N_SPEC,
        dense_bound_ms=dense_ms)
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
    # single PyTorch call computes it. Its plain version was timed in 4e on
    # the same input
    args = lms_args["config3 notch"]
    b_ms, b_by = bound(LMS_FLOPS_PER_SAMPLE * samples,
                       8 * samples + N_CHANNELS * 4 * (4 * 96 + 2 * 128))
    timing["lms_nr"] = dict(
        ms=time_ms(lambda: lms_bank.lms_nr_run_bank(*args), REPS),
        plain_ms=lms_plain_ms["config3 notch"], bound_ms=b_ms, bound_by=b_by,
        library_ms=None, flops=LMS_FLOPS_PER_SAMPLE * samples, samples=samples,
        steps=SEG_LEN)
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
    # at 128 ch x SEG_NR. plain_ms is the plain chain's time on its checked
    # span, scaled to the segment for SAM (its PLL loop is host-bound);
    # the library yardstick is the products the kernel computes, as fp32
    # torch.matmul; the bound adds the LMS's and the PLL's operations to the
    # products'
    lib_nr_ms = {}
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
            fz = torch.randn((rows_k, 256), generator=gen, device="cuda",
                             dtype=torch.complex64) if spectral else None
            prods = [(f1, w_band), (f2, w_p)]
            lib_nr_ms[key] = time_ms(lambda: [torch.matmul(a, w) for a, w in prods] + (
                [torch.fft.ifft(torch.fft.fft(fz))] if spectral else []), REPS)
            del f1, f2, fz, prods
        per_sample = ((6 if b.demod == "am" else 0)
                      + (PLL_FLOPS_PER_SAMPLE + DC_FLOPS_PER_SAMPLE if b.demod == "sam" else 0)
                      + (NB_FLOPS_PER_SAMPLE if b.config.noise_blanker else 0)
                      + (0 if spectral else LMS_FLOPS_PER_SAMPLE))
        flops = (rows_k * 2 * (512 * w_band.shape[1] + 256 * w_p.shape[1])
                 + (rows_k * SPEC_STAGE_FLOPS_PER_ROW if spectral else 0)
                 + per_sample * samples_k)
        nbytes = ((8 + (4 if denoise else 8)) * samples_k
                  + 4 * (512 * w_band.shape[1] + 256 * w_p.shape[1])
                  + c * (2 * 8 + 4 * 128 * 4 + 2 * 4)
                  + (c * 2 * (96 + 96 + 128) * 4 if not spectral else c * 2 * (4 + 2 * 128 * 4))
                  + (c * 2 * 2 * 4 if dsb else 0) + (c * 2 * 2 * 4 if b.demod == "sam" else 0)
                  + (c * (2 * 4 + 2 * 128 * 4) if b.config.noise_blanker else 0))
        b_ms, b_by = bound(flops, nbytes + (4 * 512 if spectral else 0))   # + the twiddles
        if spectral:
            dense = bound(flops + rows_k * (SPEC_DENSE_FLOPS_PER_ROW - SPEC_STAGE_FLOPS_PER_ROW),
                          nbytes + 4 * (512 * 512 + 512 * 256))[0]
        args = b.lanes_args(x_r, x_i, st)
        plain_ms, prefix = nr_plain_prefix[kname]
        timing[kname] = dict(
            ms=time_ms(lambda: lanes.sweep_lanes_chain(*args), REPS),
            plain_ms=plain_ms * (n / prefix), bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_nr_ms[key], flops=flops, samples=samples_k, seg=n, channels=c,
            **({"dense_bound_ms": dense} if spectral else {}),
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
    lms_kernels = ["lms_nr"] + [k for k in lanes.KERNELS if not k.startswith("lanes_sam")
                                and "spectral" not in k]
    say("LMS step (csrc/lms_step.cuh, the grouped algebra): cycles per LMS step (the "
        f"kernel's time over its n steps at {sm_max:.0f} MHz) "
        + ", ".join(f"{k} {timing[k]['ms'] * 1e-3 / timing[k]['steps'] * sm_max * 1e6:.1f}"
                    for k in lms_kernels)
        + "; ptxas: " + "; ".join(f"{k} {ptxas.get(k, 'not in the build log')}"
                                  for k in lms_kernels))
    spec_kernels = ["sweep_spec_chain"] + [k for k in lanes.KERNELS if "spectral" in k]
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    say("spectral stage (csrc/sweep_chain.cuh's spectral_rows: an in-block 256-point FFT, "
        f"{SPEC_STAGE_FLOPS_PER_ROW} flops a 128-sample row of the function's work in the "
        f"bound; the kernels' recompute of the forward FFT and magnitudes, "
        f"{SPEC_RECOMPUTE_FLOPS_PER_ROW} flops a row more, is overhead above it): "
        + "; ".join(
            f"{k} {timing[k]['ms']:.3f} ms, bound {timing[k]['bound_ms']:.3f} ms on the card and "
            f"{timing[k]['bound_ms'] * n_sms / min(timing[k]['channels'], n_sms):.3f} ms on the "
            f"{min(timing[k]['channels'], n_sms)} SMs its bank fills (the recompute "
            f"{timing[k]['samples'] / 128 * SPEC_RECOMPUTE_FLOPS_PER_ROW / timing[k]['flops']:.1%}"
            f" of the bound's flops; the TPU design's dense DFT "
            f"products: {timing[k]['dense_bound_ms']:.3f} ms), library "
            f"{timing[k]['library_ms']:.3f} ms, ptxas {ptxas.get(k, 'not in the build log')}"
            for k in spec_kernels))
    pll_kernels = ["sam_pll", "sweep_chain_sam", "sweep_chain_sam_nb", "sam_wide",
                   "sam_wide_nb"] + [k for k in lanes.KERNELS if k.startswith("lanes_sam")]
    lat = latency_probe(latency_lib)
    check(all(0.0 < v < 1000.0 for v in lat.values()) and lat["MUFU.RCP + FFMA"] > lat["FFMA"],
          f"the latency chains read {lat}")
    chain_cycles = sum(n_ins * lat[kind] for kind, n_ins in PLL_PATH.items())
    say("PLL step (csrc/sam_pll.cuh): latencies (cycles per link of a dependent chain of "
        f"{LATENCY_LINKS}) " + ", ".join(f"{k} {v:.2f}" for k, v in lat.items())
        + f"; the step's dependent path {PLL_PATH} = {chain_cycles:.1f} cycles, the chain bound "
        f"n x {chain_cycles:.1f} / {sm_max:.0f} MHz: "
        + ", ".join(f"{k} {timing[k]['steps'] * chain_cycles / (sm_max * 1e3):.3f} ms"
                    for k in pll_kernels))
    cyc = {k: timing[k]['ms'] * 1e-3 / timing[k]['steps'] * sm_max * 1e6 for k in pll_kernels}
    say("PLL step (csrc/sam_pll.cuh): cycles per PLL step (the kernel's time over its n steps "
        f"at {sm_max:.0f} MHz; every chain kernel walks the PLL on a warp of its own a chunk "
        "ahead of the rest of its chain, the SAM x LMS routes the LMS beside it), and beside each "
        "the excess "
        f"over the walk alone (sam_pll, {cyc['sam_pll']:.1f}): near 0 the walk paces the "
        "kernel, well above it the rest of the chain does: "
        + ", ".join(f"{k} {v:.1f} ({v - cyc['sam_pll']:+.1f})" for k, v in cyc.items()
                    if k != "sam_pll")
        + "; ptxas: " + "; ".join(
            f"{k} {ptxas.get(k + (' (G=8)' if k.startswith('sam_wide') else ''), 'not in the build log')}"
            for k in pll_kernels))
    block_s = CLI_BLOCK / FS
    say(f"timing Receiver (1 channel, {CLI_BLOCKS} threaded CLI blocks of {CLI_BLOCK} samples, "
        f"automatic I2S repair on): "
        + ", ".join(f"NR {k} {v:.3f} ms per block (real-time factor {block_s * 1e3 / v:.1f}; "
                    f"device busy {rx_busy[k][0]:.3f} ms in {rx_busy[k][1]:.0f} kernels and "
                    f"copies per block by the profiler, idle "
                    f"{100 * (1 - rx_busy[k][0] / v):.0f}%)" for k, v in rx_ms.items()))
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
        f"{library_mono_ms:.3f} ms; K4's two products and fft + ifft of its frames at config4 "
        f"{lib_spec_ms:.3f} ms; the staged spectral stage (planar.spectral_subtract_planar) "
        f"alone at config4 {spec_stage_ms:.3f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")

    # 6. the per-kernel record
    # 7. the sharded paths
    sharded_paths(gen, reset_counts, counts, only, launches, err, timing)

    sources = {"sweep_chain_ssb": ("sweep_chain.cu", "ops/pallas_sweep.py:261"),
               "sweep_chain_ssb_nb": ("sweep_chain.cu", "ops/pallas_sweep.py:261"),
               "mix_demod": ("staged.cu", "ops/pallas_kernels.py:83"),
               "pbt": ("staged.cu", "ops/pallas_kernels.py:177"),
               "sweep_chain_am": ("sweep_chain.cu", "ops/pallas_sweep.py:261"),
               "sweep_chain_am_nb": ("sweep_chain.cu", "ops/pallas_sweep.py:261"),
               "lms_nr": ("lms.cu", "ops/pallas_lms.py:36"),
               "sweep_chain_ssb_mono": ("sweep_chain.cu", "ops/pallas_sweep.py:261"),
               "sweep_spec_chain": ("sweep_spec.cu", "ops/pallas_sweep_spec.py:46"),
               "sam_pll": ("sam.cu", "ops/pallas_sam.py:226"),
               "sweep_chain_sam": ("sweep_chain.cu", "ops/pallas_chain_lanes.py:98"),
               "sweep_chain_sam_nb": ("sweep_chain.cu", "ops/pallas_chain_lanes.py:98"),
               "sam_wide": ("sam_wide.cu", "ops/pallas_sam_wide.py:49"),
               "sam_wide_nb": ("sam_wide.cu", "ops/pallas_sam_wide.py:49"),
               **{k: (f"{sweep.LIBRARIES[k.split('_')[2]]}.cu", "ops/pallas_chain_lanes.py:98")
                  for k in lanes.KERNELS},
               "sweep_mix_demod": ("staged.cu", "ops/pallas_sweep.py:59"),
               "ring_shift": ("halo.cu", "parallel/pallas_halo.py:36")}
    print(json.dumps({"kernels": [{
        "name": kname, "route": "cuda",
        "source": f"radiodsp_sdr_rx_tpu_torch/csrc/{src}",
        "replaces": f"radiodsp_sdr_rx_tpu/{tpu}",
        "launches": launches[kname], "max_abs_err": err[kname],
        "ms": timing[kname]["ms"], "plain_ms": timing[kname]["plain_ms"],
        "bound_ms": timing[kname]["bound_ms"], "bound_by": timing[kname]["bound_by"],
        "library_ms": timing[kname]["library_ms"],
        "plain_timed_samples": timing[kname].get("plain_from", timing[kname].get("seg", SEG_LEN))}
        for kname, (src, tpu) in sources.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
