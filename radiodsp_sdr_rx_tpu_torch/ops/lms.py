"""Normalised-LMS adaptive filter: noise reduction and auto-notch (``radiodsp_sdr_rx_tpu/ops/lms.py``).

The reference LMS noise reducer (src/RadioDSP_SDR_RX/RDSP_noise_reduction.h):
96 taps, a 128-sample decorrelation delay and the de-linearised dB mu law
mu = 1 / 10^((strength/2 + 2) / 10). Per sample, CMSIS ``arm_lms_norm_f32``
with desired d[n] = x[n-128]:

    y[n] = w . window(x, n)       e[n] = d[n] - y[n]
    w   += (mu * e[n] / (||window||^2 + eps)) * window(x, n)

with eps = FLT_EPSILON. Denoise returns the prediction y, the auto-notch the
error e. The first block's desired signal is the block itself (the
reference's delay line starts in phase), replicated by the ``first`` flag.

The JAX package runs one channel per ``lax.scan`` and vmaps it; the port
runs a bank (C, n) in one call of ``ops/lms_bank.lms_nr_run_bank``, which
launches the K3 kernel on the card. State leaves carry a leading channel
axis, as the JAX bank's stacked state does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

LMS_TAPS = 96          # MAX_LMS_TAPS (RDSP_noise_reduction.h:23)
LMS_DELAY = 128        # decorrelation delay (RDSP_noise_reduction.h:24)
_EPS = 1.1920929e-7    # CMSIS DELTA for arm_lms_norm_f32


def lms_mu_from_strength(strength) -> np.float32:
    """The reference's de-linearised dB mapping (RDSP_noise_reduction.h:48-56),
    host-side in float64."""
    s = np.asarray(strength, np.float64)
    return np.float32(1.0 / np.power(10.0, (s / 2.0 + 2.0) / 10.0))


class LMSState(NamedTuple):
    weights: torch.Tensor  # (C, taps) f32 adaptive coefficients
    window: torch.Tensor   # (C, taps) f32 most recent inputs (index -1 = newest)
    delay: torch.Tensor    # (C, LMS_DELAY) f32 the last inputs, the desired signal's carry
    first: torch.Tensor    # (C,) bool: True until the first block has run


def lms_nr_init(channels: int = 1, taps: int = LMS_TAPS, delay: int = LMS_DELAY,
                device="cpu") -> LMSState:
    """Fresh zeroed state (reference Init_LMS_NR, RDSP_noise_reduction.h:35-64)."""
    return LMSState(weights=torch.zeros(channels, taps, device=device),
                    window=torch.zeros(channels, taps, device=device),
                    delay=torch.zeros(channels, delay, device=device),
                    first=torch.ones(channels, dtype=torch.bool, device=device))


def lms_nr_run(x: torch.Tensor, state: LMSState, mu, mode: str = "denoise"):
    """Run the normalised LMS over a segment x (C, n). Returns (y or e, state')."""
    # deferred: lms_bank imports this module's constants. The call goes through
    # the module attribute, so a caller may wrap lms_bank.lms_nr_run_bank
    # (chip_smoke.py records its arguments that way)
    from radiodsp_sdr_rx_tpu_torch.ops import lms_bank

    out, w, win, d = lms_bank.lms_nr_run_bank(x, state.weights, state.window,
                                              state.delay, state.first, mu, mode)
    return out, LMSState(weights=w, window=win, delay=d,
                         first=torch.zeros_like(state.first))
