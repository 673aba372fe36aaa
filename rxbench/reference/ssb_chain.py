"""Plain reference of the SSB receive chain and its LMS noise reducer.

A straightforward implementation of the reference firmware's chain
(RadioDSP_SDR_RX, 44,117.647 Hz), written from its description and
independent of the program under test: it imports nothing of it and takes
nothing it made. Per channel, on planar float32 IQ:

  input gain and IQ balance -> DDS mix down by the channel's phase word ->
  overlap-save band-pass of 128-sample blocks in 256-sample frames (one
  forward FFT, the mask product, one inverse FFT, the right half kept;
  RDSP_convolutional.h:291-318) -> USB/LSB demod 2*Re -> AGC, instant attack
  and exponential release, env[k] = max(|a[k]|, env[k-1]*release), gain =
  min(target/max(env, 1e-12), max_gain) -> PBT, the same overlap-save on
  z = a(1+j), L = Re, R = Im -> [DNR: the 96-tap normalised LMS of L against
  L delayed by 128 (RDSP_noise_reduction.h:23-24, CMSIS arm_lms_norm_f32),
  its prediction times 1.1, R <- L] -> output gain.

The frame maps are the FFT -> mask -> iFFT chain applied to the unit
vectors in float64, so each frame is filtered by one fp32 matrix product.
The AGC envelope is the exact decaying maximum, taken in float64 as a
cumulative maximum in the log domain. The LMS runs 128 samples at a time
by the exact algebra of the sample-by-sample recurrence: with the weights
w0 at the group's start, y_k = w0 . x_k + sum_{j<k} c_j (x_j . x_k) and
c_k = mu e_k / (|x_k|^2 + eps), one unit lower-triangular solve a group.

Every constant is the float32 value the firmware holds. ``tf32=True``
rounds every operand of every matrix product to TF32 (10 mantissa bits, to
nearest, as ``cvt.rna.tf32.f32``) and accumulates in fp32: the chain one
precision below the configuration's, the control of the comparison.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BLOCK = 128
LMS_EPS = 1.1920929e-7   # FLT_EPSILON, CMSIS arm_lms_norm_f32's delta
LMS_GROUP = 128          # samples a group of the LMS's exact algebra
_LMS_BATCH = 16          # groups whose Gram matrices are formed at once
_WORD = 1 << 32


# --- filter design (RDSP_convolutional.h:87-185), float64 on the host ---

def design_window(window_id: int, num_taps: int) -> np.ndarray:
    """The firmware's five FIR windows (RDSP_convolutional.h:152-179)."""
    n = np.arange(num_taps, dtype=np.float64)
    t = 2.0 * np.pi * n / (num_taps - 1)
    series = {1: (0.35875, 0.48829, 0.14128, 0.01168),
              2: (0.355768, 0.487396, 0.144232, 0.012604)}
    if window_id == 3:
        return np.cos(np.pi * n / (num_taps - 1))
    if window_id == 4:
        return 0.5 * (1.0 - np.cos(t))
    a = series.get(window_id, (0.3635819, 0.4891775, 0.1365995, 0.0106411))
    return a[0] - a[1] * np.cos(t) + a[2] * np.cos(2 * t) - a[3] * np.cos(3 * t)


def band_mask(lo_hz: float, hi_hz: float, fs: float, fft_length: int, num_taps: int,
              window_id: int) -> np.ndarray:
    """The complex windowed-sinc band-pass (calc_cplx_FIR_coeffs), zero-padded
    to ``fft_length`` with the last tap's imaginary part cleared, as the
    firmware's zero-fill loop does, and transformed: the frequency mask."""
    fc = (hi_hz - lo_hz) / (2.0 * fs)
    shift = np.pi * (hi_hz + lo_hz) / fs
    x = np.arange(num_taps, dtype=np.float64) - 0.5 * (num_taps - 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.sin(2.0 * np.pi * x * fc) / (np.pi * x) * design_window(window_id, num_taps)
    z = np.where(np.abs(x) < 0.01, 2.0 * fc, z)
    h = np.zeros(fft_length, np.complex128)
    h[:num_taps] = z * np.exp(1j * shift * x)
    if 2 * num_taps > fft_length + 1:
        h[num_taps - 1] = h[num_taps - 1].real
    return np.fft.fft(h)


def frame_map(mask: np.ndarray) -> np.ndarray:
    """(half, N) complex128: the output half of iFFT(mask * FFT(frame)) for
    each unit frame, so that y = A @ frame."""
    n = len(mask)
    return np.fft.ifft(mask[:, None] * np.fft.fft(np.eye(n), axis=0), axis=0)[n // 2:]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (ties away from zero), kept in fp32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class SsbChain:
    """The chain for a bank of channels. ``settings`` is the configuration
    file's dict; ``process(xr, xi, state)`` takes one span of (C, n) planar
    IQ, n a multiple of 128, and returns ({"audio_l", "audio_r"}, state')."""

    def __init__(self, settings: dict, device, tf32: bool = False):
        s = settings
        fs = float(s["sample_rate"])
        self.device = torch.device(device)
        self.tf32 = tf32
        self.f32 = lambda v: float(np.float32(v))
        lo, hi = s["audio_filter_hz"]
        iq_band = (lo, hi) if s["sideband"] == "usb" else (-hi, -lo)
        taps, fft = int(s["fir_taps"]), int(s["fft_length"])
        if fft != 2 * BLOCK:
            raise ValueError("the chain frames 128-sample blocks in 256-sample FFTs")
        a_sb = frame_map(band_mask(*iq_band, fs, fft, taps, int(s["fir_window"])))
        a_pbt = frame_map(band_mask(s["pbt_hz"][0], s["pbt_hz"][1], fs, fft, taps,
                                    int(s["fir_window"])))

        def operator(a):   # y = frames @ operator
            return torch.tensor(np.ascontiguousarray(a.T), dtype=torch.float32,
                                device=self.device)

        self.sb_r, self.sb_i = operator(a_sb.real), operator(a_sb.imag)
        self.pbt_r, self.pbt_i = operator(a_pbt.real), operator(a_pbt.imag)
        freqs = float(s["first_channel_hz"]) + float(s["channel_spacing_hz"]) * np.arange(
            int(s["channels"]))
        cycles = (freqs - float(s["capture_center_hz"])) / fs
        self.incs = torch.tensor(np.round((cycles - np.floor(cycles)) * _WORD).astype(np.int64)
                                 % _WORD, device=self.device)
        self.release = np.float32(math.exp(-1.0 / (float(s["agc_release_s"]) * fs)))
        self.target, self.max_gain = self.f32(s["agc_target"]), self.f32(s["agc_max_gain"])
        self.gain_i = self.f32(s["input_gain"])
        self.gain_q = self.f32(float(s["input_gain"]) * float(s["iq_gain_balance"]))
        self.out_gain = self.f32(s["output_gain"])
        self.lms = s.get("nr") == "lms"
        if self.lms:
            self.mu = self.f32(1.0 / 10.0 ** ((float(s["nr_level"]) / 2.0 + 2.0) / 10.0))
            self.taps, self.delay = int(s["lms_taps"]), int(s["lms_delay"])
            self.makeup = self.f32(s["lms_makeup"])
        self.channels = int(s["channels"])

    def init_state(self) -> dict:
        c, dev = self.channels, self.device
        state = {"nco_phase": torch.zeros(c, dtype=torch.int64, device=dev),
                 "sb_tail": torch.zeros(c, 2 * BLOCK, device=dev),
                 "mixed_tail": torch.zeros(2, c, BLOCK, device=dev),
                 "audio_tail": torch.zeros(c, BLOCK, device=dev),
                 "agc_env": torch.full((c,), 1e-6, device=dev)}
        if self.lms:
            state.update(lms_weights=torch.zeros(c, self.taps, device=dev),
                         lms_window=torch.zeros(c, self.taps, device=dev),
                         lms_delay=torch.zeros(c, self.delay, device=dev),
                         lms_first=True)
        return state

    def _mm(self, a, b):
        if self.tf32:
            a, b = tf32_round(a), tf32_round(b)
        return torch.matmul(a, b)

    def _mix(self, xr, xi, phase0):
        n = xr.shape[1]
        words = (phase0[:, None] + torch.arange(n, device=xr.device)[None] * self.incs[:, None]) \
            % _WORD
        ang = words.to(torch.float64) * (2.0 * math.pi / _WORD)
        c, s = torch.cos(ang).float(), torch.sin(ang).float()
        del ang, words
        return xr * c + xi * s, xi * c - xr * s

    def _agc(self, a, env0):
        """The exact decaying maximum, in float64, and the gain applied."""
        d = -math.log(float(self.release))
        k = torch.arange(a.shape[1], dtype=torch.float64, device=a.device)
        log_a = torch.log(a.abs().double()) + d * k
        start = torch.log(env0.double()) + d * -1.0
        log_env = torch.cummax(torch.maximum(log_a, start[:, None]), dim=1).values - d * k
        env = torch.exp(log_env).float()
        gain = torch.clamp(self.target / env.clamp(min=1e-12), max=self.max_gain)
        return a * gain, env[:, -1].contiguous()

    def _frames(self, cur, tail):
        c, n = cur.shape
        rows = cur.view(c, n // BLOCK, BLOCK)
        prev = torch.cat([tail[:, None], rows[:, :-1]], dim=1)
        return torch.cat([prev, rows], dim=-1)           # (C, rows, 256)

    def process(self, xr, xi, state: dict):
        c, n = xr.shape
        sb_tail = torch.cat([xr[:, -BLOCK:], xi[:, -BLOCK:]], dim=1)
        zr, zi = self._mix(xr * self.gain_i, xi * self.gain_q, state["nco_phase"])
        fr = self._frames(zr, state["mixed_tail"][0])
        fi = self._frames(zi, state["mixed_tail"][1])
        mixed_tail = torch.stack([zr[:, -BLOCK:], zi[:, -BLOCK:]])
        del zr, zi
        audio = 2.0 * (self._mm(fr, self.sb_r) - self._mm(fi, self.sb_i))
        del fr, fi
        audio, env = self._agc(audio.reshape(c, n), state["agc_env"])
        frames = self._frames(audio, state["audio_tail"])
        yr, yi = self._mm(frames, self.pbt_r), self._mm(frames, self.pbt_i)
        del frames
        left, right = (yr - yi).reshape(c, n), (yr + yi).reshape(c, n)
        del yr, yi
        new = {"nco_phase": (state["nco_phase"] + n * self.incs) % _WORD,
               "sb_tail": sb_tail,
               "mixed_tail": mixed_tail,
               "audio_tail": audio[:, -BLOCK:].contiguous(), "agc_env": env}
        if self.lms:
            y, w, window, delay = self.nlms(left, state)
            new.update(lms_weights=w, lms_window=window, lms_delay=delay, lms_first=False)
            left = y * self.makeup * self.out_gain
            return {"audio_l": left, "audio_r": left}, new
        return {"audio_l": left * self.out_gain, "audio_r": right * self.out_gain}, new

    def nlms(self, x, state, group: int = LMS_GROUP):
        """The normalised LMS over x (C, n): returns (prediction, weights',
        window', delay'). The desired sample is x delayed by ``delay``; on the
        stream's first block the firmware's delay line starts in phase, so
        the desired sample of its first ``delay`` samples is x itself. The
        groups' Gram matrices and systems, which the weights do not enter,
        are formed for ``_LMS_BATCH`` groups at once."""
        c, n = x.shape
        taps = self.taps
        xp = torch.cat([state["lms_window"], x], dim=1)   # the window at step m: xp[m+1 : m+taps+1]
        past = torch.cat([state["lms_delay"], x], dim=1)
        want = past[:, :n].clone()
        if state["lms_first"]:
            want[:, :self.delay] = x[:, :self.delay]
        w = state["lms_weights"]
        out = torch.empty_like(x)
        eye = torch.eye(group, dtype=x.dtype, device=x.device)
        below = eye.new_ones(group, group, dtype=torch.bool).tril(-1)
        b0 = 0
        while b0 < n:   # whole groups in batches, then a short last group alone
            g, u = (min(_LMS_BATCH, (n - b0) // group), group) if n - b0 >= group else (1, n - b0)
            b1 = b0 + g * u
            wins = xp[:, b0 + 1:b1 + taps].unfold(1, taps, 1).reshape(c, g, u, taps)
            gram = self._mm(wins, wins.transpose(2, 3))       # x_j . x_k
            inv = self.mu / (torch.diagonal(gram, dim1=2, dim2=3) + LMS_EPS)
            lower = torch.where(below[:u, :u], gram, 0.0)
            system = inv[..., None] * lower + eye[:u, :u]
            rhs_want = inv * want[:, b0:b1].view(c, g, u)
            for k in range(g):
                win = wins[:, k]
                p = self._mm(win, w[:, :, None])[..., 0]
                coef = torch.linalg.solve_triangular(
                    system[:, k], (rhs_want[:, k] - inv[:, k] * p)[..., None],
                    upper=False, unitriangular=True)
                t0 = b0 + k * u
                out[:, t0:t0 + u] = p + self._mm(lower[:, k], coef)[..., 0]
                w = w + self._mm(coef.transpose(1, 2), win)[:, 0]
            b0 = b1
        return out, w, xp[:, -taps:].contiguous(), past[:, -self.delay:].contiguous()

def make(settings: dict, device, tf32: bool = False) -> SsbChain:
    return SsbChain(settings, device, tf32)
