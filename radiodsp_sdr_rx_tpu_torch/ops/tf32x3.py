"""The 3xTF32 product of the tensor-core kernels, modelled in PyTorch.

``csrc/tc_gemm.cuh`` (K2b ``pbt``, K1-nb ``sweep_chain_ssb_nb``) splits each
fp32 operand x into two TF32 values, big = rna(x) and small = rna(x - big),
with ``cvt.rna.tf32.f32`` (round to nearest, ties away from zero, to 10
mantissa bits), and sums a @ b as small_a @ big_b + big_a @ small_b +
big_a @ big_b, each product of two TF32 values exact in fp32, the sums in
fp32. ``split_tf32`` and ``matmul_3xtf32`` are that algebra on any device;
the tests hold it to float64 on the bank's operators. Nothing on the main
path calls them: on the CPU the wrappers run the plain fp32 versions.
"""

from __future__ import annotations

import torch

from radiodsp_sdr_rx_tpu_torch.ops.chain_common import matmul_fp32

_LOW = (1 << 13) - 1   # the 13 mantissa bits TF32 drops


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32 as ``cvt.rna.tf32.f32``: to nearest, ties away
    from zero (the magnitude's bits plus half a TF32 unit, the low 13 bits
    cleared); infinities and NaNs pass through."""
    bits = x.contiguous().view(torch.int32)
    out = ((bits + (1 << 12)) & ~_LOW).view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small): big = rna(x), small = rna(x - big), both TF32 values in
    fp32; big + small is x to about 2^-22 relative."""
    big = round_tf32(x)
    return big, round_tf32(x - big)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the tensor-core kernels compute it: small_a @ big_b + big_a @
    small_b + big_a @ big_b, in fp32."""
    a_big, a_small = split_tf32(a)
    b_big, b_small = split_tf32(b)
    return (matmul_fp32(a_small, b_big) + matmul_fp32(a_big, b_small)) + matmul_fp32(a_big, b_big)
