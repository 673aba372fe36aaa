"""The port's CUDA kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA card and nvcc; without them each skips (the
``cuda_device`` fixture decides at run time). On the card:
``python -m pytest tests/test_torch_kernels_cuda.py -q``.
Tolerance 1e-4, as in chip_smoke.py: both are fp32 (TF32 off), the sums are
taken in another order, and the AGC gain of up to 316 amplifies rounding.
"""

import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu_torch.models.config import AGCMode, DemodMode, ReceiverConfig
from radiodsp_sdr_rx_tpu_torch.models.fused import FusedSSBBank
from radiodsp_sdr_rx_tpu_torch.ops import sweep

pytestmark = pytest.mark.cuda
ATOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bank(agc, channels, device=None):
    cfg = ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_200_000.0,
                         capture_center_freq=7_190_000.0, agc=agc)
    return FusedSSBBank(cfg, [7_190_000.0 + 1_000.0 * k for k in range(channels)],
                        device=device)


@pytest.mark.parametrize("channels, n, agc", [
    (8, 8192, AGCMode.MEDIUM),   # one whole 64-row chunk
    (3, 8576, AGCMode.FAST),     # a partial last chunk (67 rows)
    (4, 256, AGCMode.OFF),       # two rows, AGC off
])
def test_kernel_matches_plain_over_two_segments(cuda_device, channels, n, agc):
    bank = _bank(agc, channels, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    state = bank.init_state()
    for _ in range(2):
        xr = torch.randn((channels, n), generator=gen, device=cuda_device) * 0.1
        xi = torch.randn((channels, n), generator=gen, device=cuda_device) * 0.1
        xr[:, n // 3:n // 3 + 100] *= 30.0
        ref = sweep.sweep_full_chain_plain(*bank.chain_args(xr, xi, state))
        out, state = bank.process_planar(xr, xi, state)
        got = (out["audio_l"], out["audio_r"], state.audio_tail, state.agc_env)
        for g, r in zip(got, ref):
            assert bool(torch.isfinite(g).all())
            np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), atol=ATOL, rtol=0)


def test_default_device_launches_once_per_segment(cuda_device):
    bank = _bank(AGCMode.MEDIUM, 8)
    assert bank.device.type == "cuda"
    state = bank.init_state()
    x = torch.zeros((8, 1024), device=cuda_device)
    before = sweep.LAUNCHES
    for _ in range(3):
        _, state = bank.process_planar(x, x, state)
    torch.cuda.synchronize()
    assert sweep.LAUNCHES == before + 3


def test_kernel_rejects_strided_input(cuda_device):
    bank = _bank(AGCMode.MEDIUM, 4, cuda_device)
    x = torch.zeros((4, 512), device=cuda_device)
    args = list(bank.chain_args(x, x, bank.init_state()))
    args[0] = torch.zeros((4, 1024), device=cuda_device)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        sweep.sweep_full_chain(*args)
