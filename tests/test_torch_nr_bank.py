"""The port's FusedNRBank on the CPU vs the JAX package.

Each route against the JAX ``FusedNRBank`` (Pallas in interpret mode,
``kernel_precision=None``, 1024-sample chunks so that the chunk carries are
crossed) over two threaded segments of 8 ch x 4096: ``fold=True`` spectral
(K4) and ``fold=False`` DNR2, notch and SPEC2. The audio is held to 1e-4,
the sweep parity bound (both f32; sums in another order, the AGC gain and
the LMS adaptation carry the rounding), and the state field by field: the
DDS phase, ``sb_tail``, ``lms_first`` and the padded LMS rows bit for bit,
the rest at 1e-4 (``agc_env`` and ``nfloor`` relative). Measured: 1.1e-6
at most over audio and state (the notch route's LMS weights), ``agc_env``
and ``nfloor`` 1.1e-6 relative. Against the port's ``ReceiverBank`` the
bound is the JAX test's, 2e-3 (tests/test_fused_bank.py:181-197, ``nfloor``
rtol 1e-3); measured 1.4e-6 (spectral, both folds), 2.1e-7 (notch), 7.5e-8
(DNR2).
"""

import functools

import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu.models import config as jcfg
from radiodsp_sdr_rx_tpu.models.fused import FusedNRBank as JaxFusedNRBank
from radiodsp_sdr_rx_tpu.models.fused import FusedNRBankState as JaxFusedNRBankState
from radiodsp_sdr_rx_tpu_torch.models import config as tcfg
from radiodsp_sdr_rx_tpu_torch.models.fused import FusedNRBank, FusedNRBankState
from radiodsp_sdr_rx_tpu_torch.models.receiver import ReceiverBank
from radiodsp_sdr_rx_tpu_torch.ops import lms_bank, staged, sweep, sweep_spec
from radiodsp_sdr_rx_tpu_torch.utils import convert

N_CH, N = 8, 4096
JAX_ATOL = 1e-4
BANK_ATOL = 2e-3
# route: (mode, nr, fold, vfo, capture centre)
ROUTES = {
    "spec2_fold": ("USB", "SPEC2", True, 7_200_000.0, 7_190_000.0),
    "dnr2": ("USB", "DNR2", False, 7_200_000.0, 7_190_000.0),
    "notch": ("CW_NARROW", "NOTCH", False, 14_050_000.0, 14_049_000.0),
    "spec2": ("LSB", "SPEC2", False, 7_100_000.0, 7_110_000.0),
}
EXACT = ("nco_phase", "sb_tail", "lms_first", "dc", "pll", "nb_avg", "nb_mask")


def _configs(route, **extra):
    mode, nr, _, vfo, center = ROUTES[route]
    kw = dict(vfo_freq=vfo, capture_center_freq=center, input_gain=0.9,
              iq_gain_balance=1.02, **extra)
    return (jcfg.ReceiverConfig(mode=jcfg.DemodMode[mode], nr=jcfg.NRMode[nr],
                                agc=jcfg.AGCMode.MEDIUM, **kw),
            tcfg.ReceiverConfig(mode=tcfg.DemodMode[mode], nr=tcfg.NRMode[nr],
                                agc=tcfg.AGCMode.MEDIUM, **kw))


def _freqs(route):
    center = ROUTES[route][4]
    return [center + 1_000.0 * k for k in range(N_CH)]


def _scene(route, segments=3):
    """Noise with a burst (the AGC attacks, then releases) and a tone that
    channel 2 receives (the LMS adapts to it, the spectral floor keeps it)."""
    rng = np.random.default_rng(sorted(ROUTES).index(route))
    n = segments * N
    t = np.arange(n) / 44117.64706
    iq = (rng.standard_normal((N_CH, n)) + 1j * rng.standard_normal((N_CH, n))) * 0.1
    iq[:, N // 2:N // 2 + 400] *= 20.0
    iq += 0.3 * np.exp(2j * np.pi * (2_000.0 + 900.0) * t)
    return iq.astype(np.complex64)


def _seg(iq, k):
    return iq[:, k * N:(k + 1) * N]


@functools.lru_cache(maxsize=None)
def _jax_run(route):
    """The JAX bank over three segments: outputs and the states between."""
    jc, _ = _configs(route)
    bank = JaxFusedNRBank(jc, _freqs(route), block_t=1024, lms_chunk=2048,
                          fold=ROUTES[route][2], kernel_precision=None, interpret=True)
    iq = _scene(route)
    st = bank.init_state()
    outs, states = [], [st]
    for k in range(3):
        out, st = bank.process(_seg(iq, k), st)
        outs.append({key: np.asarray(v) for key, v in out.items()})
        states.append(st)
    return bank, outs, states


def _port(route):
    return FusedNRBank(_configs(route)[1], _freqs(route), fold=ROUTES[route][2], device="cpu")


def _check_state(got: FusedNRBankState, want):
    d = convert.state_to_numpy(got)
    assert set(d) == set(JaxFusedNRBankState._fields)
    for name, w in want._asdict().items():
        w = np.asarray(w)
        assert d[name].shape == w.shape and d[name].dtype == w.dtype, name
        if name in EXACT:
            np.testing.assert_array_equal(d[name], w, err_msg=name)
        elif name in ("agc_env", "nfloor"):
            np.testing.assert_allclose(d[name], w, rtol=JAX_ATOL, err_msg=name)
        else:
            np.testing.assert_allclose(d[name], w, atol=JAX_ATOL, rtol=0, err_msg=name)
    for name in ("lms_weights", "lms_window", "lms_delay"):   # the padded rows
        assert not d[name][N_CH:].any() and not np.asarray(getattr(want, name))[N_CH:].any()


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_bank_matches_jax_bank(route):
    port = _port(route)
    _, want, jstates = _jax_run(route)
    iq = _scene(route)
    st = port.init_state()
    for k in range(2):
        got, st = port.process(_seg(iq, k), st)
        for key in ("audio_l", "audio_r"):
            assert got[key].shape == (N_CH, N)
            np.testing.assert_allclose(got[key].numpy(), want[k][key], atol=JAX_ATOL, rtol=0)
        _check_state(st, jstates[k + 1])
    if ROUTES[route][1] == "DNR2":
        assert torch.equal(got["audio_l"], got["audio_r"])
    else:
        assert not torch.equal(got["audio_l"], got["audio_r"])


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_jax_state_continues_in_port_and_back(route):
    """The JAX bank's state after segment 0 continues in the port
    (utils/convert.py) through segment 1; the port's state goes back into
    the JAX bank for segment 2, and converts back to the same port state bit
    for bit."""
    bank, want, jstates = _jax_run(route)
    iq = _scene(route)
    port = _port(route)
    st = convert.state_from_numpy(jstates[1]._asdict(), "cpu")
    assert isinstance(st, FusedNRBankState) and st.lms_first.dtype == torch.bool
    got, st = port.process(_seg(iq, 1), st)
    for key in ("audio_l", "audio_r"):
        np.testing.assert_allclose(got[key].numpy(), want[1][key], atol=JAX_ATOL, rtol=0)
    back = JaxFusedNRBankState(**convert.state_to_numpy(st))
    for a, b in zip(convert.state_from_numpy(back, "cpu"), st):
        assert torch.equal(a, b)
    out_j, _ = bank.process(_seg(iq, 2), back)
    out_t, _ = port.process(_seg(iq, 2), st)
    for key in ("audio_l", "audio_r"):
        np.testing.assert_allclose(out_t[key].numpy(), np.asarray(out_j[key]),
                                   atol=JAX_ATOL, rtol=0)
        np.testing.assert_allclose(out_t[key].numpy(), want[2][key], atol=JAX_ATOL, rtol=0)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_bank_matches_receiver_bank(route):
    _, tc = _configs(route)
    port = _port(route)
    ref = ReceiverBank(tc, _freqs(route), device="cpu")
    iq = _scene(route)
    st, st_ref = port.init_state(), ref.init_state()
    for k in range(2):
        got, st = port.process(_seg(iq, k), st)
        want, st_ref = ref.process(_seg(iq, k), st_ref)
        for key in ("audio_l", "audio_r"):
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=BANK_ATOL,
                                       rtol=0)
        np.testing.assert_allclose(st.nfloor.numpy(), st_ref.nfloor.numpy(), rtol=1e-3,
                                   atol=1e-6)
    if ROUTES[route][1] == "SPEC2":
        assert float(st.nfloor.min()) > 0.0


def test_init_state_matches_jax_bank():
    jc, tc = _configs("dnr2")
    want = JaxFusedNRBank(jc, _freqs("dnr2"), fold=False).init_state()
    got = convert.state_to_numpy(FusedNRBank(tc, _freqs("dnr2"), fold=False,
                                             device="cpu").init_state())
    assert list(got) == list(JaxFusedNRBankState._fields)
    for name, w in want._asdict().items():
        np.testing.assert_array_equal(got[name], w)
        assert got[name].dtype == np.asarray(w).dtype


def test_cpu_routes_never_launch():
    before = (sweep.LAUNCHES, sweep.LAUNCHES_MONO, sweep_spec.LAUNCHES, lms_bank.LAUNCHES,
              staged.LAUNCHES_MIX_DEMOD, staged.LAUNCHES_PBT)
    x = np.zeros((N_CH, 256), np.float32)
    for route in ROUTES:
        port = _port(route)
        port.process_planar(x, x, port.init_state())
    assert (sweep.LAUNCHES, sweep.LAUNCHES_MONO, sweep_spec.LAUNCHES, lms_bank.LAUNCHES,
            staged.LAUNCHES_MIX_DEMOD, staged.LAUNCHES_PBT) == before


@pytest.mark.parametrize("cfg_kw, fold, n_ch, error", [
    ({"nr": "OFF"}, True, 8, ValueError),                          # NR off
    ({"nr": "DNR2", "noise_blanker": True}, False, 8, ValueError),  # blanker staged
    ({"nr": "SPEC2", "mode": "AM"}, False, 8, ValueError),          # AM staged
    ({"nr": "DNR1", "mode": "SAM"}, False, 8, ValueError),          # SAM staged
    ({"nr": "SPEC2"}, False, 129, ValueError),                      # > 128 channels staged
    ({"nr": "DNR2"}, True, 8, "lanes_ssb_denoise"),                 # lms folded: K6
    ({"nr": "NOTCH"}, True, 8, "lanes_ssb_notch"),                  # notch folded: K6
    ({"nr": "SPEC2", "mode": "AM"}, True, 8, "lanes_am_spectral"),  # AM + NR: K6
    ({"nr": "DNR1", "mode": "SAM"}, True, 8, "lanes_sam_denoise"),  # SAM + NR: K6
    ({"nr": "SPEC2", "noise_blanker": True}, True, 8, "lanes_ssb_spectral_nb"),  # NR + NB: K6
])
def test_rejects_as_jax_or_names_the_lanes_kernel(cfg_kw, fold, n_ch, error):
    """The JAX bank's ValueErrors stay; every route that runs the lanes kernel
    K6 in JAX builds on the port's route "lanes" and names its instantiation."""
    kw = dict(cfg_kw)
    jc, tc = _configs("dnr2")
    nr, mode = kw.pop("nr"), kw.pop("mode", "USB")
    tc = tc.with_(nr=tcfg.NRMode[nr], mode=tcfg.DemodMode[mode], **kw)
    freqs = [7_190_000.0 + 100.0 * k for k in range(n_ch)]
    if isinstance(error, str):
        bank = FusedNRBank(tc, freqs, fold=fold, device="cpu")
        assert (bank.route, bank.kernel, bank.lanes) == ("lanes", error, 128)
        return
    with pytest.raises(error):
        FusedNRBank(tc, freqs, fold=fold, device="cpu")
    jc = jc.with_(nr=jcfg.NRMode[nr], mode=jcfg.DemodMode[mode], **kw)
    with pytest.raises(ValueError):
        JaxFusedNRBank(jc, freqs, fold=fold, interpret=True)
