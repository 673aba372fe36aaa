"""AGC presets: host math copied from ``radiodsp_sdr_rx_tpu/ops/agc.py``.

Instant attack, exponential release: env[n] = max(|x[n]|, env[n-1]*release),
gain = min(target/env, max_gain). The scan itself runs inside the sweep
kernel (ops/sweep.py); this module only builds its constants.
"""

from __future__ import annotations

import math
from typing import NamedTuple


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
