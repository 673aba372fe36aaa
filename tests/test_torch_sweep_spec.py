"""The port's K4 chain (``sweep_spec_chain``) and the mono sweep chain on the
CPU, their plain PyTorch versions, vs the JAX package's Pallas kernels in
interpret mode (``precision=None``), two threaded segments.

``sweep_spec_chain_plain`` against JAX ``sweep_spec_chain`` at 8 ch x 4096
with ``chunk_t=1024``, so that the kernel's chunk carries (framing tails,
AGC envelope, noise floor, spectral frame tails) are crossed, at AGC MEDIUM
and OFF, unit gains and input gain / balance 0.7 / 1.02: every one of the
seven outputs <= 1e-4 (both f32; the products and scans sum in another
order, the floor's recurrence too, and the AGC gain amplifies that). The
measured max is 2.1e-6, on audio of magnitude up to 1.4 (AGC off); the
floor, up to 2.9, agrees to 8.7e-7 relative.
``sweep_full_chain(emit_r=False)`` against JAX's: R is None, L and the
carries <= 1e-4 (measured 9.5e-7), L equal to the stereo plain L.
"""

import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu.models.config import AGCMode, DemodMode, NRMode, ReceiverConfig
from radiodsp_sdr_rx_tpu.models.receiver import build_params
from radiodsp_sdr_rx_tpu.ops.pallas_sweep import sweep_full_chain as jax_sweep
from radiodsp_sdr_rx_tpu.ops.pallas_sweep_spec import sweep_spec_chain as jax_spec_chain
from radiodsp_sdr_rx_tpu.ops.spectral_sub import spectral_matmul_ops as jax_spec_ops
from radiodsp_sdr_rx_tpu_torch.ops import sweep, sweep_spec
from radiodsp_sdr_rx_tpu_torch.ops.spectral_sub import spectral_matmul_ops

ATOL = 1e-4
C, N = 8, 4096


def _t(a, dtype=torch.float32):
    a = np.array(a)
    return torch.as_tensor(a.astype(np.int64) if dtype is torch.int64 else a, dtype=dtype)


def _setup(agc, seed):
    p = build_params(ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_200_000.0,
                                    capture_center_freq=7_190_000.0, agc=agc,
                                    nr=NRMode.SPEC2))
    rng = np.random.default_rng(seed)
    inc = rng.integers(0, 2**32, C, dtype=np.uint64).astype(np.uint32)
    phase = rng.integers(0, 2**32, C, dtype=np.uint64).astype(np.uint32)
    kw = dict(agc_release=float(p.agc_release), agc_target=float(p.agc_target),
              agc_max_gain=float(p.agc_max_gain), agc_enabled=bool(p.agc_enabled))
    return p, rng, inc, phase, kw


def _segment(rng, seg):
    """Noise with a burst (the AGC attacks, then releases) and a tone."""
    xr = rng.standard_normal((C, N)).astype(np.float32) * 0.1
    xi = rng.standard_normal((C, N)).astype(np.float32) * 0.1
    xr[:, N // 3:N // 3 + 300] *= 30.0
    t = np.arange(seg * N, (seg + 1) * N) / 44117.64706
    xr += (0.5 * np.cos(2 * np.pi * 11_700.0 * t)).astype(np.float32)
    xi += (0.5 * np.sin(2 * np.pi * 11_700.0 * t)).astype(np.float32)
    return xr, xi


@pytest.mark.parametrize("agc", [AGCMode.MEDIUM, AGCMode.OFF])
@pytest.mark.parametrize("in_gain, balance, out_gain", [(1.0, 1.0, 1.0), (0.7, 1.02, 0.5)])
def test_plain_matches_jax_interpret(agc, in_gain, balance, out_gain):
    p, rng, inc, phase, kw = _setup(agc, seed=int(in_gain * 10) + len(agc.value))
    kw.update(out_gain=out_gain, in_gain=in_gain, iq_balance=balance)
    w_fwd, w_inv = jax_spec_ops(256)
    tails = np.zeros((C, 256), np.float32)
    atail = np.zeros((C, 128), np.float32)
    env = np.full(C, 1e-6, np.float32)
    nfloor = np.zeros(C, np.float32)
    stl = np.zeros((C, 128), np.float32)
    st_r = np.zeros((C, 128), np.float32)
    tw_fwd, tw_inv = (_t(w) for w in spectral_matmul_ops(256))
    for seg in range(2):
        xr, xi = _segment(rng, seg)
        want = jax_spec_chain(xr, xi, inc, phase, p.w_ssb, p.w_pbt, w_fwd, w_inv,
                              tails[:, :128], tails[:, 128:], atail, env, nfloor, stl, st_r,
                              nr_level=30.0, chunk_t=1024, interpret=True, precision=None, **kw)
        got = sweep_spec.sweep_spec_chain(
            _t(xr), _t(xi), _t(inc, torch.int64), _t(phase, torch.int64), _t(p.w_ssb),
            _t(p.w_pbt), tw_fwd, tw_inv, _t(tails[:, :128]), _t(tails[:, 128:]), _t(atail),
            _t(env), _t(nfloor), _t(stl), _t(st_r), 30.0, **kw)
        assert len(got) == 7
        for g, w in zip(got, want):
            assert g.shape == tuple(np.shape(w))
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
        np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), rtol=1e-5)
        atail, env, nfloor, stl, st_r = (np.asarray(w) for w in want[2:])
        tails = np.concatenate([xr[:, -128:], xi[:, -128:]], axis=1)
        phase = (phase.astype(np.uint64) + N * inc.astype(np.uint64)).astype(np.uint32)
    assert float(nfloor.min()) > 0.0


@pytest.mark.parametrize("agc", [AGCMode.MEDIUM, AGCMode.OFF])
def test_mono_plain_matches_jax_interpret(agc):
    p, rng, inc, phase, kw = _setup(agc, seed=21)
    kw.update(out_gain=1.0, in_gain=0.7, iq_balance=1.02)
    tails = np.zeros((C, 256), np.float32)
    atail = np.zeros((C, 128), np.float32)
    env = np.full(C, 1e-6, np.float32)
    for seg in range(2):
        xr, xi = _segment(rng, seg)
        want = jax_sweep(xr, xi, inc, phase, p.w_ssb, p.w_pbt, tails[:, :128], tails[:, 128:],
                         atail, env, chunk_t=1024, emit_r=False, interpret=True, **kw)
        args = (_t(xr), _t(xi), _t(inc, torch.int64), _t(phase, torch.int64), _t(p.w_ssb),
                _t(p.w_pbt), _t(tails[:, :128]), _t(tails[:, 128:]), _t(atail), _t(env))
        got = sweep.sweep_full_chain(*args, emit_r=False, **kw)
        assert want[1] is None and got[1] is None and len(got) == 4
        for i in (0, 2, 3):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), atol=ATOL, rtol=0)
        assert torch.equal(got[0], sweep.sweep_full_chain(*args, **kw)[0])
        atail, env = np.asarray(want[2]), np.asarray(want[3])
        tails = np.concatenate([xr[:, -128:], xi[:, -128:]], axis=1)
        phase = (phase.astype(np.uint64) + N * inc.astype(np.uint64)).astype(np.uint32)


def _args(c=2, n=256):
    f = torch.zeros
    return [f(c, n), f(c, n), f(c, dtype=torch.int64), f(c, dtype=torch.int64),
            f(512, 128), f(256, 256), f(512, 512), f(512, 256), f(c, 128), f(c, 128),
            f(c, 128), torch.full((c,), 1e-6), f(c), f(c, 128), f(c, 128), 30.0,
            0.9999, 0.5, 316.0]


def _sweep_args():
    """_args() without K4's own: the sweep chain's arguments."""
    return [a for i, a in enumerate(_args()) if i not in (6, 7, 12, 13, 14, 15)]


@pytest.mark.parametrize("index, bad", [
    (0, torch.zeros(2, 200)),                   # n not a multiple of 128
    (2, torch.zeros(2, dtype=torch.int32)),     # DDS words must be int64
    (4, torch.zeros(512, 256)),                 # w_ssb shape
    (6, torch.zeros(512, 256)),                 # w_spec_fwd shape
    (7, torch.zeros(512, 512)),                 # w_spec_inv shape
    (12, torch.zeros(3)),                       # nfloor0 shape
    (13, torch.zeros(2, 64)),                   # spec_tail_l shape
    (14, torch.zeros(2, 128, dtype=torch.float64)),   # spec_tail_r dtype
    (16, 0.0),                                  # release outside (0, 1]
])
def test_wrapper_rejects_bad_arguments(index, bad):
    args = _args()
    args[index] = bad
    with pytest.raises(ValueError):
        sweep_spec.sweep_spec_chain(*args)


def test_wrapper_rejects_other_devices():
    args = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in _args()]
    with pytest.raises(ValueError):
        sweep_spec.sweep_spec_chain(*args)


@pytest.mark.parametrize("extra", [
    {"nb": True, "nb_avg0": torch.zeros(2), "nb_mask0": torch.ones(2, 128)},
])
def test_mono_takes_no_blanker(extra):
    with pytest.raises(ValueError, match="emit_r=False"):
        sweep.sweep_full_chain(*_sweep_args(), emit_r=False, **extra)


def test_cpu_tensors_never_launch():
    before = (sweep_spec.LAUNCHES, sweep.LAUNCHES_MONO)
    out = sweep_spec.sweep_spec_chain(*_args())
    assert all(bool(torch.isfinite(o).all()) for o in out)
    sweep.sweep_full_chain(*_sweep_args(), emit_r=False)
    assert (sweep_spec.LAUNCHES, sweep.LAUNCHES_MONO) == before
