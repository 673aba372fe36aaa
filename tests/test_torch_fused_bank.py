"""The port's FusedSSBBank on the CPU vs the JAX package's banks.

Against the XLA ``ReceiverBank`` the bound is 2e-3, the bound of
tests/test_fused_bank.py:37-40 (the fused chain frames and scans in another
order than the per-channel XLA chain); the measured max is recorded below.
Streaming continuity is the port against itself (1e-5), and the state
carry-across is checked both as a round trip and by continuing a stream in
the other package (1e-4, the sweep parity bound of test_torch_sweep.py).
The staged backend is held to the JAX staged bank in interpret mode at
1e-4 and to the port's sweep backend at 2e-4, the JAX staged-vs-sweep bound
of tests/test_fused_bank.py:66-88. The noise blanker runs on the impulse
scene of tests/test_fused_bank.py:484-545 (2e-3, ``nb_avg`` rtol 1e-4).
"""

import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu.models import config as jcfg
from radiodsp_sdr_rx_tpu.models.fused import FusedBankState as JaxFusedBankState
from radiodsp_sdr_rx_tpu.models.fused import FusedSSBBank as JaxFusedSSBBank
from radiodsp_sdr_rx_tpu.models.receiver import ReceiverBank
from radiodsp_sdr_rx_tpu_torch.models import fused as tfused
from radiodsp_sdr_rx_tpu_torch.models import config as tcfg
from radiodsp_sdr_rx_tpu_torch.models.fused import FusedSSBBank
from radiodsp_sdr_rx_tpu_torch.utils import convert

N_CH, N = 8, 8192
CENTER = 7_190_000.0
FREQS = [CENTER + 1_000.0 * k for k in range(N_CH)]
# measured max |port - ReceiverBank| over both segments and L/R: 3.0e-7
# (sweep), 3.0e-7 (staged), 1.5e-7 (noise blanker, impulse scene; nb_avg
# 2.7e-6 relative)
BANK_ATOL = 2e-3
# measured max |staged - sweep| in the port: 8.9e-8; |port - JAX staged|:
# 3.6e-7; a stream continued from a JAX state: 1.2e-7
BACKENDS_ATOL = 2e-4
JAX_ATOL = 1e-4


def _configs(agc="MEDIUM", **extra):
    kw = dict(vfo_freq=7_200_000.0, capture_center_freq=CENTER, **extra)
    return (jcfg.ReceiverConfig(mode=jcfg.DemodMode.USB, agc=jcfg.AGCMode[agc], **kw),
            tcfg.ReceiverConfig(mode=tcfg.DemodMode.USB, agc=tcfg.AGCMode[agc], **kw))


def _clip_for_nb(iq, cap_ratio=2.2):
    """Keep every blanker decision away from the threshold: a sample within
    rounding of mag == avg*thresh may flip between two summation orders of
    the average. Clip the noise magnitude; impulses are planted far above
    (tests/test_fused_bank.py:484-494)."""
    mag = np.abs(iq)
    cap = cap_ratio * float(mag.mean())
    return (iq * np.minimum(1.0, cap / np.maximum(mag, 1e-12))).astype(np.complex64)


def _warm_nb(iq, st_j, st_t):
    """Warm-start both blanker averages at the scene's mean magnitude, past the
    cold-start ramp (tests/test_fused_bank.py:497-504)."""
    warm = np.full(st_j.nb_avg.shape, float(np.abs(iq).mean()), np.float32)
    return st_j._replace(nb_avg=warm), st_t._replace(nb_avg=torch.from_numpy(warm.copy()))


def _nb_scene(rng, n):
    iq = _clip_for_nb((rng.standard_normal((N_CH, 2 * n))
                       + 1j * rng.standard_normal((N_CH, 2 * n))) * 0.05)
    for pos in (500, 1733, n - 3, n - 1, n + 901):   # incl. the segment's last sample
        iq[:, pos] = 8.0 * (1 + 1j)
    return iq


def _iq(rng, n=N):
    iq = (rng.standard_normal((N_CH, n)) + 1j * rng.standard_normal((N_CH, n))) * 0.1
    iq[:, n // 2:n // 2 + 400] *= 20.0
    return iq.astype(np.complex64)


@pytest.mark.parametrize("backend, agc", [
    pytest.param("sweep", "MEDIUM", id="MEDIUM"),
    pytest.param("sweep", "OFF", id="OFF"),
    pytest.param("staged", "MEDIUM", id="staged-MEDIUM"),
    pytest.param("staged", "OFF", id="staged-OFF"),
])
def test_bank_matches_receiver_bank(backend, agc):
    jc, tc = _configs(agc)
    ref = ReceiverBank(jc, FREQS)
    port = FusedSSBBank(tc, FREQS, backend=backend, device="cpu")
    st_ref, st = ref.init_state(), port.init_state()
    rng = np.random.default_rng(11)
    worst = 0.0
    for _ in range(2):
        iq = _iq(rng)
        want, st_ref = ref.process(iq, st_ref)
        got, st = port.process(iq, st)
        for key in ("audio_l", "audio_r"):
            w = np.asarray(want[key])
            np.testing.assert_allclose(got[key].numpy(), w, atol=BANK_ATOL, rtol=0)
            worst = max(worst, float(np.abs(got[key].numpy() - w).max()))
    assert np.array_equal(st.nco_phase.numpy(), np.asarray(st_ref.nco_phase).astype(np.int64))
    assert worst < BANK_ATOL


def test_streaming_continuity():
    _, tc = _configs()
    port = FusedSSBBank(tc, FREQS, device="cpu")
    iq = _iq(np.random.default_rng(5), 2 * N)
    whole, _ = port.process(iq, port.init_state())
    first, st = port.process(iq[:, :N], port.init_state())
    second, _ = port.process(iq[:, N:], st)
    for key in ("audio_l", "audio_r"):
        got = torch.cat([first[key], second[key]], dim=1)
        np.testing.assert_allclose(got.numpy(), whole[key].numpy(), atol=1e-5, rtol=0)


def test_state_round_trips_through_jax():
    jc, tc = _configs()
    jax_bank = JaxFusedSSBBank(jc, FREQS, block_t=2048, interpret=True)
    port = FusedSSBBank(tc, FREQS, device="cpu")
    rng = np.random.default_rng(2)
    _, st = port.process(_iq(rng), port.init_state())

    d = convert.state_to_numpy(st)
    assert d["nco_phase"].dtype == np.uint32
    jax_state = JaxFusedBankState(**d)
    back = convert.state_from_numpy(jax_state._asdict(), "cpu")
    for name in st._fields:
        assert torch.equal(getattr(back, name), getattr(st, name)), name

    # continue the same stream in each package from the carried state
    iq = _iq(rng)
    want, jst = jax_bank.process(iq, jax_state)
    got, st = port.process(iq, back)
    for key in ("audio_l", "audio_r"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(st.agc_env.numpy(), np.asarray(jst.agc_env), rtol=1e-5)
    assert np.array_equal(convert.state_to_numpy(st)["nco_phase"], np.asarray(jst.nco_phase))


def test_params_from_jax_operators():
    jc, tc = _configs()
    port = FusedSSBBank(tc, FREQS, device="cpu")
    p = convert.params_from_numpy(JaxFusedSSBBank(jc, FREQS).params._asdict(), "cpu")
    assert p.w_ssb.is_contiguous() and p.w_pbt.is_contiguous()
    assert all(a.is_contiguous() for a in port.chain_args(
        torch.zeros(N_CH, 256), torch.zeros(N_CH, 256), port.init_state())[:10])
    assert torch.equal(p.w_ssb, port.params.w_ssb)
    assert torch.equal(p.w_pbt, port.params.w_pbt)
    assert (p.agc_release, p.agc_target, p.agc_max_gain, p.agc_enabled) == (
        port.params.agc_release, port.params.agc_target, port.params.agc_max_gain,
        port.params.agc_enabled)


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = _configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FusedSSBBank(tc, FREQS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.resolve_device()


@pytest.mark.parametrize("kw, cfg_kw", [
    ({"backend": "staged"}, {}),
    ({}, {"noise_blanker": True}),
])
def test_staged_and_nb_entry_points_run(kw, cfg_kw):
    """The two entry points that raised NotImplementedError until this slice
    was ported now build on the CPU, run a segment and thread their carries."""
    _, tc = _configs()
    port = FusedSSBBank(tc.with_(**cfg_kw), FREQS, device="cpu", **kw)
    assert port.backend == kw.get("backend", "sweep")
    st0 = port.init_state()
    iq = _iq(np.random.default_rng(4))
    iq[:, -1] = 8.0 * (1 + 1j)                  # blanked when the blanker is on
    out, st = port.process(iq, st0)
    assert out["audio_l"].shape == (N_CH, N) and bool(torch.isfinite(out["audio_l"]).all())
    assert not torch.equal(st.sb_tail, st0.sb_tail)
    assert torch.equal(st.nb_mask[:, -1], torch.zeros(N_CH) if cfg_kw else torch.ones(N_CH))


@pytest.mark.parametrize("agc", ["MEDIUM", "OFF"])
def test_staged_matches_jax_staged_and_port_sweep(agc):
    jc, tc = _configs(agc)
    jax_bank = JaxFusedSSBBank(jc, FREQS, block_t=2048, backend="staged", interpret=True)
    staged = FusedSSBBank(tc, FREQS, backend="staged", device="cpu")
    sweep = FusedSSBBank(tc, FREQS, device="cpu")
    jst, st, sst = jax_bank.init_state(), staged.init_state(), sweep.init_state()
    rng = np.random.default_rng(21)
    for _ in range(2):
        iq = _iq(rng)
        want, jst = jax_bank.process(iq, jst)
        got, st = staged.process(iq, st)
        other, sst = sweep.process(iq, sst)
        for key in ("audio_l", "audio_r"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       atol=JAX_ATOL, rtol=0)
            np.testing.assert_allclose(got[key].numpy(), other[key].numpy(),
                                       atol=BACKENDS_ATOL, rtol=0)
        d = convert.state_to_numpy(st)
        for name in ("nco_phase", "sb_tail"):    # the staged carry: scaled, not mixed
            np.testing.assert_array_equal(d[name], np.asarray(getattr(jst, name)))
        np.testing.assert_allclose(d["audio_tail"], np.asarray(jst.audio_tail), atol=JAX_ATOL)
        np.testing.assert_allclose(d["agc_env"], np.asarray(jst.agc_env), rtol=1e-5)
        np.testing.assert_allclose(st.agc_env.numpy(), sst.agc_env.numpy(), rtol=1e-4)


def test_nb_bank_matches_receiver_bank():
    """FusedSSBBank(noise_blanker=True) == ReceiverBank on the impulse scene,
    the blanker's average and keep mask threaded across two segments so that
    a blanked tail sample carries into the next segment's framing."""
    n = 4096
    jc, tc = _configs(noise_blanker=True, nb_threshold_db=10.0, nb_tau_samples=256.0)
    ref, port = ReceiverBank(jc, FREQS), FusedSSBBank(tc, FREQS, device="cpu")
    iq = _nb_scene(np.random.default_rng(1234), n)
    st_ref, st = _warm_nb(iq, ref.init_state(), port.init_state())
    for sl in (slice(0, n), slice(n, 2 * n)):
        want, st_ref = ref.process(iq[:, sl], st_ref)
        got, st = port.process(iq[:, sl], st)
        for key in ("audio_l", "audio_r"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       atol=BANK_ATOL, rtol=0)
        if sl.start == 0:
            assert st.nb_mask[:, -1].max() == 0.0     # the last sample was blanked
    np.testing.assert_allclose(st.nb_avg.numpy(), np.asarray(st_ref.nb_avg), rtol=1e-4)


@pytest.mark.parametrize("backend, cfg_kw", [
    ("staged", {}),
    ("sweep", {"noise_blanker": True, "nb_tau_samples": 256.0}),
])
def test_jax_state_continues_in_port(backend, cfg_kw):
    """A stream started in the JAX bank continues in the port from the JAX
    state, carried across with utils/convert.py, for both backends."""
    n = 4096
    jc, tc = _configs(**cfg_kw)
    jax_bank = JaxFusedSSBBank(jc, FREQS, block_t=1024, backend=backend, interpret=True)
    port = FusedSSBBank(tc, FREQS, backend=backend, device="cpu")
    rng = np.random.default_rng(8)
    iq = _nb_scene(rng, n) if cfg_kw else _iq(rng, 2 * n)
    jst = jax_bank.init_state()
    if cfg_kw:
        jst, _ = _warm_nb(iq, jst, port.init_state())
    _, jst = jax_bank.process(iq[:, :n], jst)
    st = convert.state_from_numpy(
        {k: np.asarray(v) for k, v in jst._asdict().items()}, "cpu")
    assert isinstance(st, tfused.FusedBankState)
    want, jst = jax_bank.process(iq[:, n:], jst)
    got, st = port.process(iq[:, n:], st)
    for key in ("audio_l", "audio_r"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=JAX_ATOL, rtol=0)
    back = convert.state_to_numpy(st)
    for name in ("nco_phase", "sb_tail", "nb_mask"):
        np.testing.assert_array_equal(back[name], np.asarray(getattr(jst, name)))
    np.testing.assert_allclose(back["nb_avg"], np.asarray(jst.nb_avg), rtol=1e-5)
    np.testing.assert_allclose(back["agc_env"], np.asarray(jst.agc_env), rtol=1e-5)


@pytest.mark.parametrize("cfg_kw, kw", [
    ({"mode": tcfg.DemodMode.AM}, {}),
    ({"nr": tcfg.NRMode.DNR1}, {}),
    ({}, {"backend": "xla"}),
    ({"noise_blanker": True}, {"backend": "staged"}),   # as the JAX bank
])
def test_rejects_configs_outside_the_bank(cfg_kw, kw):
    _, tc = _configs()
    with pytest.raises(ValueError):
        FusedSSBBank(tc.with_(**cfg_kw), FREQS, device="cpu", **kw)
