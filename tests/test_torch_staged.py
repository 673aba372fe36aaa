"""The staged kernels' plain versions on the CPU vs the JAX wrappers
(``ops/pallas_kernels.py``) in Pallas interpret mode, two threaded segments.

Tolerance 1e-5: both are fp32 products of the same frames and operators,
summed in another order, with no AGC after them to amplify the rounding.
The measured max is 1.3e-7 for the mix + demod and 0 for the PBT.
"""

import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu.models.config import AGCMode, DemodMode, ReceiverConfig
from radiodsp_sdr_rx_tpu.models.receiver import build_params
from radiodsp_sdr_rx_tpu.ops import pallas_kernels as jk
from radiodsp_sdr_rx_tpu_torch.ops import staged

ATOL = 1e-5
C, N = 8, 4096


def _t(a, dtype=torch.float32):
    a = np.array(a)
    return torch.as_tensor(a.astype(np.int64) if dtype is torch.int64 else a, dtype=dtype)


def _params():
    return build_params(ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_200_000.0,
                                       capture_center_freq=7_190_000.0,
                                       agc=AGCMode.MEDIUM))


@pytest.mark.parametrize("in_gain, balance, warm_tail", [
    (1.0, 1.0, False),     # unit gains from stream start
    (0.7, 1.02, True),     # gains folded into the kernel, a carried tail
])
def test_mix_demod_plain_matches_jax_interpret(in_gain, balance, warm_tail):
    p = _params()
    rng = np.random.default_rng(int(warm_tail))
    inc = rng.integers(0, 2**32, C, dtype=np.uint64).astype(np.uint32)
    phase = rng.integers(0, 2**32, C, dtype=np.uint64).astype(np.uint32)
    g_i = np.float32(in_gain)
    g_q = g_i * np.float32(balance)     # as the JAX bank multiplies them
    tail = (rng.standard_normal((C, 256)).astype(np.float32) * 0.1 if warm_tail
            else np.zeros((C, 256), np.float32))
    worst = 0.0
    for _ in range(2):
        xr = rng.standard_normal((C, N)).astype(np.float32) * 0.1
        xi = rng.standard_normal((C, N)).astype(np.float32) * 0.1
        want = jk.fused_mix_filter_demod(xr * g_i, xi * g_q, inc, phase, p.w_ssb,
                                         tail=tail, block_t=2048, interpret=True)
        got = staged.fused_mix_filter_demod(
            _t(xr), _t(xi), _t(inc, torch.int64), _t(phase, torch.int64), _t(p.w_ssb),
            _t(tail), float(g_i), float(g_q))
        assert got.shape == (C, N)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        worst = max(worst, float(np.abs(got.numpy() - np.asarray(want)).max()))
        # the staged carry: the scaled, unmixed last block
        tail = np.concatenate([xr[:, -128:] * g_i, xi[:, -128:] * g_q], axis=1)
        phase = (phase.astype(np.uint64) + N * inc.astype(np.uint64)).astype(np.uint32)
    assert worst < ATOL


@pytest.mark.parametrize("out_gain, warm_tail", [(1.0, False), (0.5, True)])
def test_pbt_plain_matches_jax_interpret(out_gain, warm_tail):
    p = _params()
    rng = np.random.default_rng(10 + int(warm_tail))
    tail = (rng.standard_normal((C, 128)).astype(np.float32) if warm_tail
            else np.zeros((C, 128), np.float32))
    for _ in range(2):
        audio = rng.standard_normal((C, N)).astype(np.float32)
        want = jk.pbt_filter(audio, p.w_pbt, tail=tail, block_t=2048, interpret=True)
        got = staged.pbt_filter(_t(audio), _t(p.w_pbt), _t(tail), out_gain)
        for g, w in zip(got, want):
            assert g.shape == (C, N)
            np.testing.assert_allclose(g.numpy(), np.asarray(w) * np.float32(out_gain),
                                       atol=ATOL, rtol=0)
        tail = audio[:, -128:]


def _mix_args(c=2, n=256):
    f = torch.zeros
    return [f(c, n), f(c, n), f(c, dtype=torch.int64), f(c, dtype=torch.int64),
            f(512, 128), f(c, 256)]


def _pbt_args(c=2, n=256):
    return [torch.zeros(c, n), torch.zeros(256, 256), torch.zeros(c, 128)]


@pytest.mark.parametrize("fn, args, index, bad", [
    (staged.fused_mix_filter_demod, _mix_args, 0, torch.zeros(2, 200)),   # n % 128
    (staged.fused_mix_filter_demod, _mix_args, 1, torch.zeros(2, 128)),   # xi shape
    (staged.fused_mix_filter_demod, _mix_args, 2, torch.zeros(2, dtype=torch.int32)),
    (staged.fused_mix_filter_demod, _mix_args, 4, torch.zeros(256, 128)),  # w shape
    (staged.fused_mix_filter_demod, _mix_args, 5, torch.zeros(2, 128)),   # tail is [re|im]
    (staged.fused_mix_filter_demod, _mix_args, 0, torch.zeros(2, 256, dtype=torch.float64)),
    (staged.pbt_filter, _pbt_args, 0, torch.zeros(2, 0)),                 # empty stream
    (staged.pbt_filter, _pbt_args, 1, torch.zeros(512, 128)),             # w shape
    (staged.pbt_filter, _pbt_args, 2, torch.zeros(2, 256)),               # tail shape
])
def test_wrappers_reject_bad_arguments(fn, args, index, bad):
    a = args()
    a[index] = bad
    with pytest.raises(ValueError):
        fn(*a)


@pytest.mark.parametrize("fn, args", [(staged.fused_mix_filter_demod, _mix_args),
                                      (staged.pbt_filter, _pbt_args)])
def test_wrappers_reject_other_devices(fn, args):
    with pytest.raises(ValueError):
        fn(*[a.to("meta") for a in args()])


def test_cpu_tensors_never_launch():
    before = (staged.LAUNCHES_MIX_DEMOD, staged.LAUNCHES_PBT)
    audio = staged.fused_mix_filter_demod(*_mix_args())
    staged.pbt_filter(audio, *_pbt_args()[1:])
    assert (staged.LAUNCHES_MIX_DEMOD, staged.LAUNCHES_PBT) == before
