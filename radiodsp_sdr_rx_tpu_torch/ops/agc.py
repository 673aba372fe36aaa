"""AGC: presets and the staged backend's envelope (``radiodsp_sdr_rx_tpu/ops/agc.py``).

Instant attack, exponential release: env[n] = max(|x[n]|, env[n-1]*release),
gain = min(target/env, max_gain). The sweep kernel runs this scan inside
itself (ops/sweep.py). The staged backend runs it between its two kernels as
``agc_run``: the JAX package's scan-free log-domain form, a cumulative max of
log|x| offset by k*d (d = -log(release)), in chunks of 16384 samples with
the envelope carried from chunk to chunk. In JAX it is XLA outside any
Pallas kernel; here it is plain PyTorch on whatever device the tensor is.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class AGCParams(NamedTuple):
    """AGC configuration. release is the per-sample envelope decay (1.0 => hold)."""

    release: float
    target: float
    max_gain: float
    enabled: bool = True


def preset_from_release_time(release_time_s: float, sample_rate: float,
                             target=0.5, max_gain=316.0) -> AGCParams:
    """release such that the envelope decays by 1/e over release_time_s."""
    return AGCParams(release=math.exp(-1.0 / (release_time_s * sample_rate)),
                     target=target, max_gain=max_gain)


def agc_presets(sample_rate: float, target: float = 0.5,
                max_gain: float = 316.0) -> dict[str, AGCParams]:
    """off/fast/medium/slow (menu cycle at RDSP_controls.h:196-232); release
    times 0.25 / 0.6 / 2 s, as in the JAX package."""
    return {
        "off": AGCParams(release=1.0, target=1.0, max_gain=1.0, enabled=False),
        "fast": preset_from_release_time(0.25, sample_rate, target, max_gain),
        "medium": preset_from_release_time(0.6, sample_rate, target, max_gain),
        "slow": preset_from_release_time(2.0, sample_rate, target, max_gain),
    }


_LOG_FLOOR = -30.0  # log of the least envelope tracked (~1e-13 amplitude)
_CHUNK = 16384      # keeps k*d small enough for f32 on long streams


def _envelope_chunk(log_a, log_env0, d):
    """Decaying-max envelope of one chunk in the log domain by a cumulative max."""
    k = torch.arange(log_a.shape[-1], dtype=torch.float32, device=log_a.device)
    kd = k * d
    shifted = torch.maximum(log_a, log_env0[..., None] - (k + 1.0) * d) + kd
    log_env = torch.cummax(shifted, dim=-1).values - kd
    return log_env, log_env[..., -1]


def agc_envelope(mag: torch.Tensor, env0: torch.Tensor, release):
    """env[n] = max(mag[n], env[n-1]*release), scan-free.

    mag: (..., n) non-negative f32; env0: (...,) carry from the previous
    segment. Returns (env, env_last).
    """
    floor = torch.exp(torch.tensor(_LOG_FLOOR, dtype=torch.float32, device=mag.device))
    d = -torch.log(torch.tensor(float(release), dtype=torch.float32, device=mag.device))
    log_a = torch.log(torch.maximum(mag, floor))
    log_env = torch.log(torch.maximum(env0, floor))
    n = mag.shape[-1]
    if n <= _CHUNK:
        log_env, last = _envelope_chunk(log_a, log_env, d)
    else:
        chunks = []
        for t0 in range(0, n, _CHUNK):
            chunk = log_a[..., t0:t0 + _CHUNK]
            if chunk.shape[-1] < _CHUNK:   # the JAX form pads the last chunk
                chunk = torch.nn.functional.pad(
                    chunk, (0, _CHUNK - chunk.shape[-1]), value=_LOG_FLOOR)
            le, log_env = _envelope_chunk(chunk, log_env, d)
            chunks.append(le)
        log_env = torch.cat(chunks, dim=-1)[..., :n]
        last = log_env[..., -1]
    return torch.exp(log_env), torch.exp(last)


def agc_run(x: torch.Tensor, params: AGCParams, env0: torch.Tensor):
    """AGC over a real audio stream (..., n). Returns (y, env_last); with
    ``enabled=False`` the signal passes and the envelope still tracks."""
    env, env_last = agc_envelope(x.abs(), env0, params.release)
    if not params.enabled:
        return x, env_last
    target = torch.tensor(float(params.target), dtype=torch.float32, device=x.device)
    gain = torch.clamp(target / env.clamp(min=1e-12), max=float(params.max_gain))
    return x * gain, env_last
