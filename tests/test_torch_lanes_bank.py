"""The port's folded NR bank on the lanes kernel's routes, on the CPU.

``FusedNRBank(fold=True)`` routes every mode x NR x blanker combination but
SSB + spectral without the blanker (K4) through ``ops/lanes.py``; on the CPU
its plain version runs. Each of the seventeen routes against the JAX
``ReceiverBank`` (the reference chain, default backend) of the same config,
two threaded segments of 8 ch x 2048, at 2e-3, the bound of the JAX
package's own lanes tests (tests/test_fused_bank.py:458-490, 571-596):
locked carriers for AM and SAM (the PLL is chaotic on noise), clipped noise
or locked carriers with decisive impulses and a warm-started average for the
blanker. Measured: at most 1.0e-6 (SAM + notch: the split-phase PLL against
the exact one, and the notch's adaptation), 3.4e-8 to 4.6e-7 on the other
routes. The SSB DNR and notch folds against the port's ``fold=False`` route
at 1e-4 (the same recurrences; measured 0 and 7.5e-8). The JAX lanes kernel
itself is held in tests/test_torch_lanes_*_jax.py.

Edge cases: a 160-channel bank's state has the JAX bank's 256 lanes and
converts both ways bit for bit; SAM with NR re-seeds its PLL every
``even_chunks(n, 1024)`` samples, with no halving of an odd chunk count;
DNR's R is L; the carries a route does not run come back as the JAX kernel
returns them.
"""

import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu.models import config as jcfg
from radiodsp_sdr_rx_tpu.models.fused import FusedNRBank as JaxFusedNRBank
from radiodsp_sdr_rx_tpu.models.fused import FusedNRBankState as JaxFusedNRBankState
from radiodsp_sdr_rx_tpu.models.receiver import ReceiverBank as JaxReceiverBank
from radiodsp_sdr_rx_tpu.ops.pallas_sweep import _even_chunks
from radiodsp_sdr_rx_tpu_torch.models import config as tcfg
from radiodsp_sdr_rx_tpu_torch.models.fused import FusedNRBank, FusedNRBankState
from radiodsp_sdr_rx_tpu_torch.ops import lanes, lms_bank, sam, sweep, sweep_spec
from radiodsp_sdr_rx_tpu_torch.utils import convert
from test_torch_sam import locked_scene

N_CH, N = 8, 2048
BANK_ATOL = 2e-3
STAGED_ATOL = 1e-4
SSB = ("USB", 7_200_000.0, 7_190_000.0)
CW = ("CW_NARROW", 14_050_000.0, 14_049_000.0)
AM = ("AM", 7_060_000.0, 7_050_000.0)
SAM = ("SAM", 7_060_000.0, 7_050_000.0)
# kernel name: ((mode, vfo, capture centre), NR mode, blanker)
ROUTES = {
    "lanes_ssb_denoise": (SSB, "DNR2", False),
    "lanes_ssb_denoise_nb": (SSB, "DNR3", True),
    "lanes_am_denoise": (AM, "DNR2", False),
    "lanes_am_denoise_nb": (AM, "DNR1", True),
    "lanes_sam_denoise": (SAM, "DNR1", False),
    "lanes_sam_denoise_nb": (SAM, "DNR2", True),
    "lanes_ssb_notch": (CW, "NOTCH", False),
    "lanes_ssb_notch_nb": (CW, "NOTCH", True),
    "lanes_am_notch": (AM, "NOTCH", False),
    "lanes_am_notch_nb": (AM, "NOTCH", True),
    "lanes_sam_notch": (SAM, "NOTCH", False),
    "lanes_sam_notch_nb": (SAM, "NOTCH", True),
    "lanes_ssb_spectral_nb": (SSB, "SPEC2", True),
    "lanes_am_spectral": (AM, "SPEC2", False),
    "lanes_am_spectral_nb": (AM, "SPEC3", True),
    "lanes_sam_spectral": (SAM, "SPEC4", False),
    "lanes_sam_spectral_nb": (SAM, "SPEC2", True),
}


def configs(route, **extra):
    (mode, vfo, center), nr, nb = ROUTES[route]
    kw = dict(vfo_freq=vfo, capture_center_freq=center, input_gain=0.9, iq_gain_balance=1.02,
              noise_blanker=nb, **extra)
    return (jcfg.ReceiverConfig(mode=jcfg.DemodMode[mode], nr=jcfg.NRMode[nr],
                                agc=jcfg.AGCMode.MEDIUM, **kw),
            tcfg.ReceiverConfig(mode=tcfg.DemodMode[mode], nr=tcfg.NRMode[nr],
                                agc=tcfg.AGCMode.MEDIUM, **kw))


def freqs(route, channels=N_CH):
    return [ROUTES[route][0][2] + 1_000.0 * k for k in range(channels)]


def scene(route, n=N, channels=N_CH):
    """Two segments (C, 2n): AM and SAM on locked carriers; SSB on noise with
    a burst (the AGC attacks, then releases) and a tone that channel 2
    receives (the LMS adapts to it), or, with the blanker, on noise clipped
    to 2.2x its mean magnitude; the blanker's impulses of 8(1+1j), one on
    the first segment's last sample, far above its threshold."""
    (mode, *_), _, nb = ROUTES[route]
    rng = np.random.default_rng(sorted(ROUTES).index(route))
    if mode in ("AM", "SAM"):
        iq = locked_scene(rng, channels, 2 * n)
    else:
        iq = (rng.standard_normal((channels, 2 * n))
              + 1j * rng.standard_normal((channels, 2 * n))) * (0.05 if nb else 0.1)
        if nb:
            mag = np.abs(iq)
            iq *= np.minimum(1.0, 2.2 * mag.mean() / np.maximum(mag, 1e-12))
        else:
            t = np.arange(2 * n) / 44117.64706
            iq[:, n // 2:n // 2 + 400] *= 20.0
            iq += 0.3 * np.exp(2j * np.pi * (2_000.0 + 900.0) * t)
    if nb:
        for pos in (n // 4, n // 2 + 7, n - 3, n - 1, n + n // 3):
            iq[:, pos] = 8.0 * (1 + 1j)
    return iq.astype(np.complex64)


def warm(route, iq, state):
    """The blanker's average warm-started at the scene's mean magnitude."""
    if not ROUTES[route][2]:
        return state
    avg = np.full((iq.shape[0],), float(np.abs(iq).mean()), np.float32)
    return state._replace(nb_avg=torch.from_numpy(avg) if isinstance(state, FusedNRBankState)
                          else avg)


def seg(iq, k, n=N):
    return iq[:, k * n:(k + 1) * n]


def port_bank(route, channels=N_CH, **kw):
    return FusedNRBank(configs(route)[1], freqs(route, channels), device="cpu", **kw)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_matches_jax_receiver_bank(route):
    jc, _ = configs(route)
    port = port_bank(route)
    assert (port.route, port.kernel) == ("lanes", route)
    ref = JaxReceiverBank(jc, freqs(route))
    iq = scene(route)
    st, st_ref = warm(route, iq, port.init_state()), warm(route, iq, ref.init_state())
    for k in range(2):
        got, st = port.process(seg(iq, k), st)
        want, st_ref = ref.process(seg(iq, k), st_ref)
        for key in ("audio_l", "audio_r"):
            assert got[key].shape == (N_CH, N)
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=BANK_ATOL,
                                       rtol=0, err_msg=key)
        if k == 0 and ROUTES[route][2]:
            assert float(st.nb_mask[:, -1].max()) == 0.0   # the impulse on the last sample
    if ROUTES[route][1].startswith("DNR"):
        assert got["audio_r"] is got["audio_l"]   # the mono copy R <- L
    else:
        assert not torch.equal(got["audio_l"], got["audio_r"])


@pytest.mark.parametrize("route", ["lanes_ssb_denoise", "lanes_ssb_notch"])
def test_ssb_lms_fold_matches_staged(route):
    """The folded DNR and notch routes against the port's fold=False route:
    the same recurrences, the LMS carries included."""
    folded, staged = port_bank(route), port_bank(route, fold=False)
    assert staged.route == "staged"
    iq = scene(route)
    st_f, st_s = folded.init_state(), staged.init_state()
    for k in range(2):
        got, st_f = folded.process(seg(iq, k), st_f)
        want, st_s = staged.process(seg(iq, k), st_s)
        for key in ("audio_l", "audio_r"):
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=STAGED_ATOL,
                                       rtol=0, err_msg=key)
        for name in ("lms_weights", "lms_window", "lms_delay", "audio_tail", "agc_env"):
            np.testing.assert_allclose(getattr(st_f, name).numpy(), getattr(st_s, name).numpy(),
                                       atol=STAGED_ATOL, rtol=0, err_msg=name)
        assert not bool(st_f.lms_first) and not bool(st_s.lms_first)


def test_wide_bank_state_has_jax_lanes_and_converts():
    """A 160-channel folded bank: its init_state has the JAX bank's fields,
    shapes (256 lanes for the LMS and PLL carries), dtypes and values; after
    a segment its state converts to JAX and back bit for bit, the padded
    lanes zero."""
    route, c, n = "lanes_sam_notch", 160, 256
    jc, _ = configs(route)
    want = JaxFusedNRBank(jc, freqs(route, c), interpret=True).init_state()
    port = port_bank(route, c)
    assert port.lanes == 256
    got = convert.state_to_numpy(port.init_state())
    assert list(got) == list(JaxFusedNRBankState._fields)
    for name, w in want._asdict().items():
        w = np.asarray(w)
        assert got[name].shape == w.shape and got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    assert got["lms_weights"].shape == (256, 96) and got["pll"].shape == (2, 256)
    _, st = port.process(seg(scene(route, n, c), 0, n), port.init_state())
    back = JaxFusedNRBankState(**convert.state_to_numpy(st))
    for a, b in zip(convert.state_from_numpy(back, "cpu"), st):
        assert torch.equal(a, b)
    assert not st.lms_weights[c:].any() and not st.pll[:, c:].any()
    assert st.lms_weights[:c].any() and st.pll[1, :c].any()


@pytest.mark.parametrize("n", [256, 1536, 2048, 3072, 5120, 1 << 19])
def test_sam_nr_reseed_schedule(n):
    """SAM with NR re-seeds its PLL at the JAX bank's chunk for SAM with NR:
    fold_chunk capped at 1024 (fused.py:317-324), _even_chunks of it, and no
    halving of an odd chunk count (the pipelined driver's, nr="none" only):
    at n = 3072 and 5120 the chunks stay 1024, where K6's SAM route halves
    them to 512."""
    for route in ("lanes_sam_notch", "lanes_sam_spectral_nb"):
        bank = port_bank(route)
        x = torch.zeros((N_CH, n))
        args = bank.lanes_args(x, x, bank.init_state())
        p = _even_chunks(n, 1024)
        assert args[-3].reseed == sam.Reseed(p, n, p)
        assert args[-3].reseed == sam.reseed_schedule(n, 1024, wide=True)
    if n in (3072, 5120):
        assert sam.reseed_schedule(n, 1024).period == 512


@pytest.mark.parametrize("route", ["lanes_ssb_notch", "lanes_am_spectral_nb",
                                   "lanes_sam_denoise"])
def test_unused_carries_come_back_as_the_jax_kernel_returns_them(route):
    """From a state with nonzero values in every slot: the LMS rows and the
    PLL come back zero where their stage does not run (and in the padded
    lanes), dc zero on SSB; nfloor, the spectral tails and the blanker's
    carries pass through when their stage is off; lms_first turns False."""
    port = port_bank(route)
    (mode, *_), nr, nb = ROUTES[route]
    st0 = port.init_state()
    st0 = st0._replace(**{name: torch.full_like(getattr(st0, name), 0.01) for name in (
        "lms_weights", "lms_window", "lms_delay", "nfloor", "spec_tail_l", "spec_tail_r",
        "dc", "pll", "nb_avg")}, nb_mask=torch.ones_like(st0.nb_mask))
    iq = scene(route)
    _, st = port.process(seg(iq, 0), st0)
    lms_on, spec_on = nr.startswith("DNR") or nr == "NOTCH", nr.startswith("SPEC")
    for name in ("lms_weights", "lms_window", "lms_delay"):
        v = getattr(st, name)
        assert not v[N_CH:].any() and bool(v[:N_CH].any()) == lms_on, name
    assert not st.pll[:, N_CH:].any() and bool(st.pll[1, :N_CH].any()) == (mode == "SAM")
    assert bool(st.dc.any()) == (mode != "USB" and mode != "CW_NARROW")
    for name in ("nfloor", "spec_tail_l", "spec_tail_r"):
        assert torch.equal(getattr(st, name), getattr(st0, name)) != spec_on, name
    assert torch.equal(st.nb_avg, st0.nb_avg) != nb
    assert not bool(st.lms_first)


def test_cpu_routes_never_launch():
    before = (dict(lanes.LAUNCHES), sweep_spec.LAUNCHES, lms_bank.LAUNCHES, sweep.LAUNCHES_SAM)
    for route in ROUTES:
        port = port_bank(route)
        iq = scene(route, 256)
        port.process(seg(iq, 0, 256), warm(route, iq, port.init_state()))
    assert (dict(lanes.LAUNCHES), sweep_spec.LAUNCHES, lms_bank.LAUNCHES,
            sweep.LAUNCHES_SAM) == before
