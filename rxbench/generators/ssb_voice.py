"""Generator ``ssb_voice``: captures of IQ with one SSB voice station a
channel, made on the device from the seed. A traffic file names it by
``"generator": "ssb_voice"``; another kind of signal is another file here.

A capture is ``capture_samples`` samples a channel, (C, n) planar float32.
Each channel's row holds one SSB voice station and complex noise:

  station = level * env(t) * sum_i g_i exp(j(2 pi (f_ch +- f_i) t + phi_i)) / sum_i g_i
  env(t)  = 0.55 + 0.45 sin(2 pi syl t + psi)      (utils/scenes.band_scene_40m_ssb)
  noise   = noise_sigma * (N(0,1) + j N(0,1))      (bench.py's 0.1-sigma noise)

with f_ch the channel's own tuning (the bank mixes it to 0 Hz), the voice's
tones f_i on the sideband the configuration receives, and the level, the
tones, the syllabic rate and every phase drawn from the seed for each channel
and capture. The station's parameters come from a numpy generator on the
host (a few numbers a channel); the noise, the bulk, from a torch generator
on the device. Every seed gives the same sizes; only the values change.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def station_params(mix: dict, channels: int, capture: int, seed: int) -> dict:
    """The seeded station of each channel of one capture (host numpy)."""
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, capture])
    s = mix["station"]
    lo, hi = s["tone_hz"]
    return {"level_db": rng.uniform(*s["level_db"], channels),
            "tones": rng.uniform(lo, hi, (channels, len(s["tone_gains"]))),
            "phases": rng.uniform(0.0, 2 * math.pi, (channels, len(s["tone_gains"]))),
            "syl_hz": rng.uniform(*s["syllabic_hz"], channels),
            "syl_phase": rng.uniform(0.0, 2 * math.pi, channels)}


def make_capture(mix: dict, settings: dict, capture: int, seed: int, device,
                 channels: int | None = None, samples: int | None = None):
    """One capture, (xr, xi) each (C, n) float32 on ``device``."""
    c = int(settings["channels"]) if channels is None else channels
    n = int(mix["capture_samples"]) if samples is None else samples
    fs = float(settings["sample_rate"])
    sign = {"usb": 1.0, "lsb": -1.0}[settings["sideband"]]
    p = station_params(mix, c, capture, seed)
    gains = np.asarray(mix["station"]["tone_gains"], np.float64)
    f_ch = float(settings["first_channel_hz"]) - float(settings["capture_center_hz"]) + \
        float(settings["channel_spacing_hz"]) * np.arange(c)
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + capture) & 0x7FFFFFFFFFFFFFFF)
    sigma = float(mix["noise_sigma"])
    xr = torch.randn(c, n, generator=gen, device=device) * sigma
    xi = torch.randn(c, n, generator=gen, device=device) * sigma
    t = torch.arange(n, dtype=torch.float64, device=device) / fs
    rows = max(1, (1 << 24) // n)    # channels a pass, about 2^24 samples
    for c0 in range(0, c, rows):
        c1 = min(c, c0 + rows)

        def col(a):
            return torch.as_tensor(np.asarray(a[c0:c1], np.float64), device=device)[:, None]

        env = 0.55 + 0.45 * torch.sin(2 * math.pi * col(p["syl_hz"]) * t + col(p["syl_phase"]))
        re = torch.zeros(c1 - c0, n, dtype=torch.float64, device=device)
        im = torch.zeros_like(re)
        for i, g in enumerate(gains):
            cyc = (col(f_ch + sign * p["tones"][:, i]) * t) % 1.0
            ang = 2 * math.pi * cyc + col(p["phases"][:, i])
            re += g * torch.cos(ang)
            im += g * torch.sin(ang)
        amp = col(10.0 ** (p["level_db"] / 20.0)) * env / gains.sum()
        xr[c0:c1] += (re * amp).float()
        xi[c0:c1] += (im * amp).float()
    return xr, xi
