"""The port's FusedSSBBank on the CPU vs the JAX package's banks.

Against the XLA ``ReceiverBank`` the bound is 2e-3, the bound of
tests/test_fused_bank.py:37-40 (the fused chain frames and scans in another
order than the per-channel XLA chain); the measured max is recorded below.
Streaming continuity is the port against itself (1e-5), and the state
carry-across is checked both as a round trip and by continuing a stream in
the other package (1e-4, the sweep parity bound of test_torch_sweep.py).
"""

import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu.models import config as jcfg
from radiodsp_sdr_rx_tpu.models.fused import FusedBankState as JaxFusedBankState
from radiodsp_sdr_rx_tpu.models.fused import FusedSSBBank as JaxFusedSSBBank
from radiodsp_sdr_rx_tpu.models.receiver import ReceiverBank
from radiodsp_sdr_rx_tpu_torch.models import config as tcfg
from radiodsp_sdr_rx_tpu_torch.models.fused import FusedSSBBank
from radiodsp_sdr_rx_tpu_torch.utils import convert

N_CH, N = 8, 8192
CENTER = 7_190_000.0
FREQS = [CENTER + 1_000.0 * k for k in range(N_CH)]
# measured max |port - ReceiverBank| over both segments and L/R: 3.0e-7
BANK_ATOL = 2e-3


def _configs(agc="MEDIUM"):
    kw = dict(vfo_freq=7_200_000.0, capture_center_freq=CENTER)
    return (jcfg.ReceiverConfig(mode=jcfg.DemodMode.USB, agc=jcfg.AGCMode[agc], **kw),
            tcfg.ReceiverConfig(mode=tcfg.DemodMode.USB, agc=tcfg.AGCMode[agc], **kw))


def _iq(rng, n=N):
    iq = (rng.standard_normal((N_CH, n)) + 1j * rng.standard_normal((N_CH, n))) * 0.1
    iq[:, n // 2:n // 2 + 400] *= 20.0
    return iq.astype(np.complex64)


@pytest.mark.parametrize("agc", ["MEDIUM", "OFF"])
def test_bank_matches_receiver_bank(agc):
    jc, tc = _configs(agc)
    ref, port = ReceiverBank(jc, FREQS), FusedSSBBank(tc, FREQS, device="cpu")
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
def test_later_slices_raise_not_implemented(kw, cfg_kw):
    _, tc = _configs()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FusedSSBBank(tc.with_(**cfg_kw), FREQS, device="cpu", **kw)


@pytest.mark.parametrize("cfg_kw, kw", [
    ({"mode": tcfg.DemodMode.AM}, {}),
    ({"nr": tcfg.NRMode.DNR1}, {}),
    ({}, {"backend": "xla"}),
])
def test_rejects_configs_outside_the_bank(cfg_kw, kw):
    _, tc = _configs()
    with pytest.raises(ValueError):
        FusedSSBBank(tc.with_(**cfg_kw), FREQS, device="cpu", **kw)
