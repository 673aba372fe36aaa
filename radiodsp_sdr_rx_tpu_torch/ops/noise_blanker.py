"""Impulse noise blanker on complex IQ (``radiodsp_sdr_rx_tpu/ops/noise_blanker.py``).

AudioSDR's blanker (``SDR.enableNoiseBlanker`` / ``setNoiseBlankerThresholdDb``,
RadioDSP_SDR_RX.ino:129-131): samples whose magnitude exceeds the running
average magnitude by the threshold are zeroed before demodulation. The
average is a one-pole IIR (``ops/iir.first_order_iir``). The receive chains
run the planar twin, ``ops/planar.noise_blanker_planar``.
"""

from __future__ import annotations

import math

import torch

from radiodsp_sdr_rx_tpu_torch.ops.iir import first_order_iir


def noise_blanker(iq: torch.Tensor, avg0: torch.Tensor, threshold_db: float = 10.0,
                  tau_samples: float = 512.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Blank impulse spikes of a complex stream iq (..., n) complex64, with
    the average-magnitude carry avg0 (...,). The pole exp(-1/tau) and the
    threshold 10^(dB/20) are computed in float64, as the JAX function's
    Python arithmetic does. Returns (blanked iq, new avg)."""
    mag = iq.abs()
    a = math.exp(-1.0 / tau_samples)
    avg, avg_last = first_order_iir(mag, a, 1.0 - a, avg0)
    thresh = 10.0 ** (threshold_db / 20.0)
    keep = mag <= avg * thresh + 1e-12
    return torch.where(keep, iq, torch.zeros_like(iq)), avg_last
