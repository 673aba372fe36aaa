"""q15 fixed-point round trip (``radiodsp_sdr_rx_tpu/ops/qformat.py``).

The reference's audio path is q15 (int16) at the I2S boundaries (CMSIS
``arm_q15_to_float`` / ``arm_float_to_q15``); these follow CMSIS exactly:

  q15_to_float: f = q / 32768
  float_to_q15: q = saturate_int16(trunc(f * 32768))   (C cast truncates toward 0)
"""

from __future__ import annotations

import torch


def q15_to_float(q: torch.Tensor) -> torch.Tensor:
    """int16 q15 -> float32 in [-1, 1)."""
    return q.to(torch.float32) * (1.0 / 32768.0)


def float_to_q15(f: torch.Tensor) -> torch.Tensor:
    """float32 -> int16: scale by 32768, truncate toward zero, saturate."""
    return torch.trunc(f * 32768.0).clamp(-32768.0, 32767.0).to(torch.int16)


def quantize_q15(f: torch.Tensor) -> torch.Tensor:
    """Round-trip float through q15, as the reference audio path does at
    every queue boundary."""
    return q15_to_float(float_to_q15(f))
