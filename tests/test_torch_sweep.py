"""The port's sweep chain on the CPU (its plain PyTorch version) vs the JAX
``sweep_full_chain`` in Pallas interpret mode, two threaded segments.

Tolerance 1e-4: both are fp32, but the products and the AGC's doubling
scans sum in another order (the port scans a whole segment, the TPU kernel
one 2048-sample chunk at a time), and the AGC gain of up to 316 amplifies
that rounding. The measured max is 2.4e-6.
"""

import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu.models.config import AGCMode, DemodMode, ReceiverConfig
from radiodsp_sdr_rx_tpu.models.receiver import build_params
from radiodsp_sdr_rx_tpu.ops.pallas_sweep import sweep_full_chain as jax_sweep
from radiodsp_sdr_rx_tpu_torch.ops import nco as tnco
from radiodsp_sdr_rx_tpu_torch.ops import sweep

ATOL = 1e-4


def _t(a, dtype=torch.float32):
    a = np.array(a)
    return torch.as_tensor(a.astype(np.int64) if dtype is torch.int64 else a, dtype=dtype)


def _run_both(n, chunk_t, agc, seed, c=8, out_gain=0.5, in_gain=1.0, balance=1.02):
    p = build_params(ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_200_000.0,
                                    capture_center_freq=7_190_000.0, agc=agc))
    rng = np.random.default_rng(seed)
    inc = rng.integers(0, 2**32, c, dtype=np.uint64).astype(np.uint32)
    phase = rng.integers(0, 2**32, c, dtype=np.uint64).astype(np.uint32)
    tails = np.zeros((c, 256), np.float32)
    atail = np.zeros((c, 128), np.float32)
    env = np.full(c, 1e-6, np.float32)
    kw = dict(agc_release=float(p.agc_release), agc_target=float(p.agc_target),
              agc_max_gain=float(p.agc_max_gain), agc_enabled=bool(p.agc_enabled),
              out_gain=out_gain, in_gain=in_gain, iq_balance=balance)
    worst = 0.0
    for _ in range(2):
        xr = rng.standard_normal((c, n)).astype(np.float32) * 0.1
        xi = rng.standard_normal((c, n)).astype(np.float32) * 0.1
        xr[:, n // 3:n // 3 + 300] *= 30.0   # a burst: AGC attack, then release
        want = jax_sweep(xr, xi, inc, phase, p.w_ssb, p.w_pbt, tails[:, :128],
                         tails[:, 128:], atail, env, chunk_t=chunk_t,
                         interpret=True, **kw)
        got = sweep.sweep_full_chain(
            _t(xr), _t(xi), _t(inc, torch.int64), _t(phase, torch.int64),
            _t(p.w_ssb), _t(p.w_pbt), _t(tails[:, :128]), _t(tails[:, 128:]),
            _t(atail), _t(env), **kw)
        for g, w in zip(got, want):
            assert g.shape == tuple(np.shape(w))
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
            worst = max(worst, float(np.abs(g.numpy() - np.asarray(w)).max()))
        atail, env = np.asarray(want[2]), np.asarray(want[3])
        tails = np.concatenate([xr[:, -128:], xi[:, -128:]], axis=1)
        phase = (phase.astype(np.uint64) + n * inc.astype(np.uint64)).astype(np.uint32)
    return worst


@pytest.mark.parametrize("n, chunk_t, agc", [
    (4096, 2048, AGCMode.MEDIUM),   # two chunks per segment
    (4096, 2048, AGCMode.OFF),      # AGC disabled: release 1, gain 1
    (6144, 2048, AGCMode.FAST),     # odd chunk count (3)
])
def test_plain_matches_jax_interpret(n, chunk_t, agc):
    assert _run_both(n, chunk_t, agc, seed=n + len(agc.value)) < ATOL


def test_plain_matches_jax_with_gains():
    assert _run_both(4096, 2048, AGCMode.SLOW, seed=7, out_gain=1.3,
                     in_gain=0.7, balance=0.97) < ATOL


def test_advance_phase_wraps_like_uint32():
    rng = np.random.default_rng(3)
    phase = rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    inc = rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    for n in (1, 128, 1 << 19, (1 << 32) + 5):
        want = (phase.astype(np.uint64) + (n % 2**32) * inc.astype(np.uint64)) % 2**32
        got = tnco.advance_phase(_t(phase, torch.int64), n, _t(inc, torch.int64))
        assert np.array_equal(got.numpy(), want.astype(np.int64))


def _args(c=2, n=256):
    f = torch.zeros
    return [f(c, n), f(c, n), f(c, dtype=torch.int64), f(c, dtype=torch.int64),
            f(512, 128), f(256, 256), f(c, 128), f(c, 128), f(c, 128),
            torch.full((c,), 1e-6), 0.9999, 0.5, 316.0]


@pytest.mark.parametrize("index, bad", [
    (0, torch.zeros(2, 200)),                   # n not a multiple of 128
    (1, torch.zeros(2, 128)),                   # xi shape differs
    (2, torch.zeros(2, dtype=torch.int32)),     # DDS words must be int64
    (4, torch.zeros(256, 128)),                 # w_ssb shape
    (9, torch.zeros(3)),                        # env0 shape
    (10, 1.5),                                  # release outside (0, 1]
])
def test_wrapper_rejects_bad_arguments(index, bad):
    args = _args()
    args[index] = bad
    with pytest.raises(ValueError):
        sweep.sweep_full_chain(*args)


def test_wrapper_rejects_other_devices():
    args = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in _args()]
    with pytest.raises(ValueError):
        sweep.sweep_full_chain(*args)


def test_cpu_tensors_never_launch():
    before = sweep.LAUNCHES
    sweep.sweep_full_chain(*_args())
    assert sweep.LAUNCHES == before
