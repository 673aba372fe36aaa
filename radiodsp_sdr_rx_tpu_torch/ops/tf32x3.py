"""The 3xTF32 product of the tensor-core kernels, modelled in PyTorch.

``csrc/tc_gemm.cuh`` (K2b ``pbt``, K1-nb ``sweep_chain_ssb_nb``) splits each
fp32 operand x into two TF32 values, big = rna(x) and small = rna(x - big),
with ``cvt.rna.tf32.f32`` (round to nearest, ties away from zero, to 10
mantissa bits), and sums a @ b as small_a @ big_b + big_a @ small_b +
big_a @ big_b, each product of two TF32 values exact in fp32, the sums in
fp32. ``split_tf32`` and ``matmul_3xtf32`` are that algebra on any device;
the tests hold it to float64 on the bank's operators. Nothing on the main
path calls them: on the CPU the wrappers run the plain fp32 versions.

``tf32_image`` is the operator as K1-ssb and K1-mono read it
(``csrc/tc_gemm.cuh``'s pre-laid feed): split once, outside the kernel, and
laid out as the exact image ``wgmma`` reads, every warpgroup's part of a K
step in one contiguous block, which the kernel brings into shared memory with
one bulk copy; ``check_image`` refuses what those copies cannot read.
"""

from __future__ import annotations

import torch

from radiodsp_sdr_rx_tpu_torch.ops.chain_common import check_tensors, matmul_fp32

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


KS = 8   # rows of the operator a K step


def tf32_image(w: torch.Tensor, parts: int, ksplit: int = 1) -> torch.Tensor:
    """The image of the fp32 operator w (K, N) that the pre-laid feed copies:
    (K / 8 / ksplit, ksplit parts, 2, 8 N / parts). Step j of the image holds
    the K steps of 8 rows j, j + K / 8 / ksplit, ... (the warpgroups' shares
    of a product split over K), each in ``parts`` column ranges, K-share
    major: part [j, h parts + p] is K step j + h K / 8 / ksplit of column
    range p, big then small (``split_tf32``, the kernels' split), each in
    ``wgmma``'s K-major core-matrix layout without a swizzle: column n of the
    range and row k of the step at float 4 (n % 8) + 32 (k // 4) + 64 (n // 8)
    + k % 4 (byte 16 (n % 8) + 128 q + 256 (n / 8) of ``tc_gemm.cuh``, 4-byte
    k within q). Contiguous: a step is one block of 32 N ksplit bytes, which
    the kernel brings in with one bulk copy. Built by integer operations and
    one exact subtraction, so its bits are the same on the CPU and on the
    card."""
    k, n = w.shape
    if ksplit < 1 or k % (KS * ksplit) or parts < 1 or n % (8 * parts):
        raise ValueError(f"a ({k}, {n}) operator has no image of {ksplit} K shares and {parts} "
                         f"column ranges: K a multiple of {KS} x ksplit, N of 8 x parts")
    if w.dtype != torch.float32:
        raise ValueError(f"the image is of an fp32 operator, not {w.dtype}")
    nc, steps = n // parts, k // KS // ksplit

    def lay(x):   # (K, N) -> (steps, ksplit parts, 8 nc) in the core-matrix order
        # h, j, q, k % 4, p, n // 8, n % 8
        x = x.reshape(ksplit, steps, 2, 4, parts, nc // 8, 8)
        return x.permute(1, 0, 4, 5, 2, 6, 3).reshape(steps, ksplit * parts, KS * nc)

    big, small = split_tf32(w)
    return torch.stack([lay(big), lay(small)], dim=2).contiguous()


def check_image(images: dict, device) -> None:
    """images: name -> (tensor, shape). Raise ValueError unless each is an
    fp32 tensor of its shape on ``device``, contiguous and 16-byte aligned, as
    the kernels' bulk copies read it."""
    for name, (t, shape) in images.items():
        if not torch.is_tensor(t):
            raise ValueError(f"{name}: the kernel takes its operator's image, "
                             f"not {type(t).__name__}")
        check_tensors({name: (t, shape, torch.float32)}, device)
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: the image must be contiguous and 16-byte aligned")
