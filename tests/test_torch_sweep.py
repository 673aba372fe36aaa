"""The port's sweep chain on the CPU (its plain PyTorch version) vs the JAX
``sweep_full_chain`` in Pallas interpret mode, two threaded segments.

Tolerance 1e-4: both are fp32, but the products and the AGC's doubling
scans sum in another order (the port scans a whole segment, the TPU kernel
one 2048-sample chunk at a time), and the AGC gain of up to 316 amplifies
that rounding. The measured max is 2.4e-6. The noise-blanker cases run on
the decisive impulse scene of tests/test_fused_bank.py:484-545 (clipped
noise, impulses far above the threshold, the average warm-started), where
no sample lies within rounding of the threshold; their measured max is
3.9e-7, and the keep masks agree exactly.
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


def _clip_for_nb(iq, cap_ratio=2.2):
    """Clip the noise magnitude to cap_ratio x its mean, so that no sample lies
    within rounding of the blanking threshold (tests/test_fused_bank.py:484)."""
    mag = np.abs(iq)
    cap = cap_ratio * float(mag.mean())
    return (iq * np.minimum(1.0, cap / np.maximum(mag, 1e-12))).astype(np.complex64)


@pytest.mark.parametrize("n, chunk_t, tau, agc", [
    (4096, 1024, 256.0, AGCMode.MEDIUM),   # the JAX bank test's blanker
    (6144, 2048, 512.0, AGCMode.OFF),      # the config default tau, 3 chunks
])
def test_plain_nb_matches_jax_interpret(n, chunk_t, tau, agc):
    p = build_params(ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_200_000.0,
                                    capture_center_freq=7_190_000.0, agc=agc))
    c = 8
    rng = np.random.default_rng(n)
    iq = _clip_for_nb((rng.standard_normal((c, 2 * n))
                       + 1j * rng.standard_normal((c, 2 * n))) * 0.05)
    for pos in (500, 1733, n - 3, n - 1, n + 901):   # one on the segment's last sample
        iq[:, pos] = 8.0 * (1 + 1j)
    inc = rng.integers(0, 2**32, c, dtype=np.uint64).astype(np.uint32)
    phase = rng.integers(0, 2**32, c, dtype=np.uint64).astype(np.uint32)
    kw = dict(agc_release=float(p.agc_release), agc_target=float(p.agc_target),
              agc_max_gain=float(p.agc_max_gain), agc_enabled=bool(p.agc_enabled),
              out_gain=0.5, in_gain=1.0, iq_balance=1.02, nb=True,
              nb_thresh_db=10.0, nb_tau=tau)
    tails = np.zeros((c, 256), np.float32)
    atail = np.zeros((c, 128), np.float32)
    env = np.full(c, 1e-6, np.float32)
    nb_avg = np.full(c, float(np.abs(iq).mean()), np.float32)   # warm start
    nb_mask = np.ones((c, 128), np.float32)
    for seg in range(2):
        xr = np.ascontiguousarray(iq.real[:, seg * n:(seg + 1) * n], np.float32)
        xi = np.ascontiguousarray(iq.imag[:, seg * n:(seg + 1) * n], np.float32)
        want = jax_sweep(xr, xi, inc, phase, p.w_ssb, p.w_pbt, tails[:, :128],
                         tails[:, 128:], atail, env, chunk_t=chunk_t, interpret=True,
                         nb_avg0=nb_avg, nb_mask0=nb_mask, **kw)
        got = sweep.sweep_full_chain(
            _t(xr), _t(xi), _t(inc, torch.int64), _t(phase, torch.int64),
            _t(p.w_ssb), _t(p.w_pbt), _t(tails[:, :128]), _t(tails[:, 128:]),
            _t(atail), _t(env), nb_avg0=_t(nb_avg), nb_mask0=_t(nb_mask), **kw)
        assert len(got) == 6
        for g, w in zip(got, want):
            assert g.shape == tuple(np.shape(w))
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
        assert np.array_equal(got[5].numpy(), np.asarray(want[5]))
        if seg == 0:   # the last sample was blanked, and its mask carries
            assert got[5].numpy()[:, -1].max() == 0.0
        atail, env, nb_avg, nb_mask = (np.asarray(w) for w in want[2:])
        tails = np.concatenate([xr[:, -128:], xi[:, -128:]], axis=1)
        phase = (phase.astype(np.uint64) + n * inc.astype(np.uint64)).astype(np.uint32)


def test_advance_phase_wraps_like_uint32():
    rng = np.random.default_rng(3)
    phase = rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    inc = rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    for n in (1, 128, 1 << 19, (1 << 32) + 5):
        want = (phase.astype(np.uint64) + (n % 2**32) * inc.astype(np.uint64)) % 2**32
        got = tnco.advance_phase(_t(phase, torch.int64), n, _t(inc, torch.int64))
        assert np.array_equal(got.numpy(), want.astype(np.int64))


def _args(c=2, n=256, nb=False):
    f = torch.zeros
    args = [f(c, n), f(c, n), f(c, dtype=torch.int64), f(c, dtype=torch.int64),
            f(512, 128), f(256, 256), f(c, 128), f(c, 128), f(c, 128),
            torch.full((c,), 1e-6), 0.9999, 0.5, 316.0]
    if nb:   # agc_enabled, the gains, then the blanker's
        args += [True, 1.0, 1.0, 1.0, True, 10.0, 512.0, f(c), torch.ones(c, 128)]
    return args


@pytest.mark.parametrize("index, bad", [
    (0, torch.zeros(2, 200)),                   # n not a multiple of 128
    (1, torch.zeros(2, 128)),                   # xi shape differs
    (2, torch.zeros(2, dtype=torch.int32)),     # DDS words must be int64
    (4, torch.zeros(256, 128)),                 # w_ssb shape
    (9, torch.zeros(3)),                        # env0 shape
    (10, 1.5),                                  # release outside (0, 1]
    (20, torch.zeros(3)),                       # nb_avg0 shape, nb=True
    (21, torch.ones(2, 64)),                    # nb_mask0 shape, nb=True
    (20, None),                                 # nb=True needs the carries
    (19, 0.0),                                  # nb_tau not positive
])
def test_wrapper_rejects_bad_arguments(index, bad):
    args = _args(nb=index >= 17)
    args[index] = bad
    with pytest.raises(ValueError):
        sweep.sweep_full_chain(*args)


def test_wrapper_rejects_other_devices():
    args = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in _args()]
    with pytest.raises(ValueError):
        sweep.sweep_full_chain(*args)


def test_cpu_tensors_never_launch():
    before = (sweep.LAUNCHES, sweep.LAUNCHES_NB)
    sweep.sweep_full_chain(*_args())
    sweep.sweep_full_chain(*_args(nb=True))
    assert (sweep.LAUNCHES, sweep.LAUNCHES_NB) == before
