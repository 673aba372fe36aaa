"""The port's ``FusedSAMBank`` on the CPU vs the JAX package.

Each route against the JAX bank of the same arguments in Pallas interpret
mode, two threaded segments on a locked-carrier scene (every channel on its
own AM carrier within 50 Hz of its mix, the SAM PLL being chaotic on
noise), <= 1e-4 on the audio and the carries (the sweep chains' bound; the
phase compared wrap-aware), the DDS words bit for bit, and ``sb_tail`` bit
for bit where it is a copy of the raw input (``fold=True``); the staged
route's ``sb_tail`` is the MIXED last block, whose sin/cos XLA and PyTorch
round apart, so it is held to 1e-6:

  - ``fold=False`` (K5 + K2b), 8 ch x 4096;
  - ``fold=True`` on K6, 8 ch x 2048, with and without the blanker (on a
    locked scene with decisive impulses), n = 3,072 (an odd chunk count: the
    PLL chunk halves) and ``max_kernel_seg=2048`` with n = 3,072 (a whole
    sub-segment, then a remainder call);
  - the wide route (K7) at 256 channels, the JAX default ``wide_groups``
    (G=2): <= 1e-4; and against the port's ``wide_groups=1`` (K6): <= 2e-3,
    their re-seed periods differing by design.

Measured on a locked scene, the re-seed period moves vr by about 2e-7, so
these comparisons cannot see it; ``tests/test_torch_sam.py`` holds the
schedule to the JAX wrappers' chunk choices.

Each route is also held to the port's ``ReceiverBank(mode=SAM)`` (the exact
PLL) at 2e-3 on the audio and the wrap-aware PLL phase, the
docs/CHIP_PARITY.md bound. ``utils/convert`` carries the state both ways.
"""

import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu.models.fused import FusedSAMBank as JaxFusedSAMBank
from radiodsp_sdr_rx_tpu.models.fused import FusedSAMBankState as JaxFusedSAMBankState
from radiodsp_sdr_rx_tpu_torch.models import config as tcfg
from radiodsp_sdr_rx_tpu_torch.models.fused import FusedSAMBank, FusedSAMBankState
from radiodsp_sdr_rx_tpu_torch.models.receiver import ReceiverBank
from radiodsp_sdr_rx_tpu_torch.ops import sam, sam_wide, staged, sweep
from radiodsp_sdr_rx_tpu_torch.utils import convert
from test_torch_sam import CENTER, configs, locked_scene, phase_diff

ATOL = 1e-4
MIXED_ATOL = 1e-6
PARITY = 2e-3


def _impulses(iq):
    """Decisive impulses of 8(1+1j) on the locked scene (one on the first
    segment's last sample); every other sample sits far below the blanking
    threshold (tests/test_fused_bank.py:484-504)."""
    n = iq.shape[1] // 2
    iq = iq.copy()
    for pos in (500, 1733, n - 3, n - 1, n + 901):
        iq[:, pos] = 8.0 * (1 + 1j)
    return iq


def _scene(c, n, seed, nb=False, spacing=1_000.0):
    iq = locked_scene(np.random.default_rng(seed), c, 2 * n, spacing)
    return _impulses(iq) if nb else iq


def _warm(iq, jst, st):
    """Warm-started blanker average (the scene's mean magnitude)."""
    warm = np.full(st.nb_avg.shape, float(np.abs(iq).mean()), np.float32)
    return jst._replace(nb_avg=warm), st._replace(nb_avg=torch.from_numpy(warm.copy()))


def _compare(got, want, st, jst, exact_tail=True):
    for key in ("audio_l", "audio_r"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL, rtol=0)
    d = convert.state_to_numpy(st)
    assert np.array_equal(d["nco_phase"], np.asarray(jst.nco_phase))
    if exact_tail:
        assert np.array_equal(d["sb_tail"], np.asarray(jst.sb_tail))
    else:
        np.testing.assert_allclose(d["sb_tail"], np.asarray(jst.sb_tail), atol=MIXED_ATOL, rtol=0)
    assert np.array_equal(d["nb_mask"], np.asarray(jst.nb_mask))
    for name in ("audio_tail", "agc_env", "sam_dc", "sam_freq", "nb_avg"):
        np.testing.assert_allclose(d[name], np.asarray(getattr(jst, name)), atol=ATOL, rtol=0)
    assert d["sam_phase"].shape == np.shape(jst.sam_phase)
    assert phase_diff(d["sam_phase"], jst.sam_phase) <= ATOL


def _run_both(jax_bank, port, iq, n, nb=False):
    """Two threaded segments through both banks; the port's states after each."""
    jst, st = jax_bank.init_state(), port.init_state()
    if nb:
        jst, st = _warm(iq, jst, st)
    states = []
    for seg in range(2):
        x = iq[:, seg * n:(seg + 1) * n]
        want, jst = jax_bank.process(x, jst)
        got, st = port.process(x, st)
        _compare(got, want, st, jst, exact_tail=port.fold)
        states.append(st)
    return states


def test_staged_matches_jax_staged():
    jc, tc = configs()
    c, n = 8, 4096
    freqs = [CENTER + 1_000.0 * k for k in range(c)]
    port = FusedSAMBank(tc, freqs, fold=False, device="cpu")
    assert port.route == "staged" and port.sam_chunk == 4096
    counts = (sam.LAUNCHES, staged.LAUNCHES_PBT)
    _, st = _run_both(JaxFusedSAMBank(jc, freqs, fold=False, interpret=True), port,
                      _scene(c, n, 21), n)
    assert (sam.LAUNCHES, staged.LAUNCHES_PBT) == counts   # CPU tensors never launch
    assert st.sam_phase.shape == (128,) and not bool(st.sam_phase[c:].any())


@pytest.mark.parametrize("n, nb, extra", [
    (2048, False, {}),
    (2048, True, {}),
    (3072, False, {}),                          # 3 chunks of 1024: the PLL chunk halves
    (3072, False, {"max_kernel_seg": 2048}),    # a 2048 sub-segment, then a remainder call
])
def test_folded_matches_jax_folded(n, nb, extra):
    jc, tc = configs(noise_blanker=nb, nb_tau_samples=256.0)
    c = 8
    freqs = [CENTER + 1_000.0 * k for k in range(c)]
    port = FusedSAMBank(tc, freqs, device="cpu", **extra)
    assert port.route == "lanes" and port.lanes == 128
    first, _ = _run_both(JaxFusedSAMBank(jc, freqs, interpret=True, **extra), port,
                         _scene(c, n, 22 + n, nb), n, nb)
    if nb:   # the impulse on segment 0's last sample was blanked, and its mask carried
        assert float(first.nb_mask[:, -1].max()) == 0.0


def test_wide_matches_jax_wide_and_port_lanes():
    jc, tc = configs()
    c, n = 256, 512
    freqs = [CENTER + 1_000.0 * k for k in range(c)]
    port = FusedSAMBank(tc, freqs, device="cpu")
    assert (port.route, port.groups, port.lanes) == ("wide", 2, 256)
    iq = _scene(c, n, 23)
    _, st = _run_both(JaxFusedSAMBank(jc, freqs, interpret=True), port, iq, n)
    narrow = FusedSAMBank(tc, freqs, wide_groups=1, device="cpu")
    assert narrow.route == "lanes"
    sn, sw = narrow.init_state(), port.init_state()
    for seg in range(2):
        x = iq[:, seg * n:(seg + 1) * n]
        a, sn = narrow.process(x, sn)
        b, sw = port.process(x, sw)
        for key in ("audio_l", "audio_r"):
            np.testing.assert_allclose(b[key].numpy(), a[key].numpy(), atol=PARITY, rtol=0)
    assert phase_diff(sw.sam_phase, sn.sam_phase) <= PARITY
    assert torch.equal(st.sam_phase, sw.sam_phase)


@pytest.mark.parametrize("route", ["staged", "lanes", "lanes_nb", "wide"])
def test_routes_match_receiver_bank(route):
    """Each route against the port's ReceiverBank(SAM) (the exact PLL, the
    XLA chain of the JAX package), two threaded segments."""
    nb = route.endswith("_nb")
    _, tc = configs(noise_blanker=nb, nb_tau_samples=256.0)
    c, n = (256, 512) if route == "wide" else (8, 2048)
    freqs = [CENTER + 1_000.0 * k for k in range(c)]
    port = FusedSAMBank(tc, freqs, fold=route != "staged", device="cpu")
    assert port.route == route.removesuffix("_nb")
    ref = ReceiverBank(tc, freqs, device="cpu")
    iq = _scene(c, n, 24, nb)
    st, st_ref = port.init_state(), ref.init_state()
    if nb:
        warm = torch.full((c,), float(np.abs(iq).mean()))
        st, st_ref = st._replace(nb_avg=warm), st_ref._replace(nb_avg=warm.clone())
    for seg in range(2):
        x = iq[:, seg * n:(seg + 1) * n]
        got, st = port.process(x, st)
        want, st_ref = ref.process(x, st_ref)
        for key in ("audio_l", "audio_r"):
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=PARITY, rtol=0)
        assert phase_diff(st.sam_phase[:c], st_ref.sam.phase) <= PARITY
        np.testing.assert_allclose(st.sam_dc.numpy(), st_ref.sam.dc.numpy(), atol=PARITY, rtol=0)


@pytest.mark.parametrize("fold", [False, True])
def test_state_converts_both_ways(fold):
    """A stream started in the JAX bank continues in the port from the JAX
    state (utils/convert.py), and the port's state goes back bit for bit."""
    jc, tc = configs()
    c, n = 8, 4096   # the JAX staged PBT kernel tiles 8 channels x 4096 samples
    freqs = [CENTER + 1_000.0 * k for k in range(c)]
    jax_bank = JaxFusedSAMBank(jc, freqs, fold=fold, interpret=True)
    port = FusedSAMBank(tc, freqs, fold=fold, device="cpu")
    iq = _scene(c, n, 25)
    _, jst = jax_bank.process(iq[:, :n], jax_bank.init_state())
    st = convert.state_from_numpy({k: np.asarray(v) for k, v in jst._asdict().items()}, "cpu")
    assert isinstance(st, FusedSAMBankState) and st.sam_phase.shape == (128,)
    want, jst = jax_bank.process(iq[:, n:], jst)
    got, st = port.process(iq[:, n:], st)
    _compare(got, want, st, jst, exact_tail=fold)
    back = convert.state_to_numpy(st)
    again = convert.state_from_numpy(JaxFusedSAMBankState(**back)._asdict(), "cpu")
    for name in st._fields:
        assert torch.equal(getattr(again, name), getattr(st, name)), name


@pytest.mark.parametrize("cfg_kw, fold, channels", [
    ({"mode": "AM"}, True, 8),                       # mode not SAM
    ({"nr": "DNR2"}, True, 8),                       # SAM + NR is FusedNRBank's
    ({"noise_blanker": True}, False, 8),             # the blanker folds only
    ({}, False, 129),                                # staged: <= 128 channels
])
def test_rejects_what_jax_rejects(cfg_kw, fold, channels):
    _, tc = configs()
    kw = {k: getattr(tcfg, "DemodMode" if k == "mode" else "NRMode")[v] if isinstance(v, str)
          else v for k, v in cfg_kw.items()}
    with pytest.raises(ValueError):
        FusedSAMBank(tc.with_(**kw), [CENTER + 100.0 * k for k in range(channels)], fold=fold,
                     device="cpu")


def test_wide_groups_override_and_routes():
    _, tc = configs()
    freqs = [CENTER + 100.0 * k for k in range(1024)]
    assert (FusedSAMBank(tc, freqs, device="cpu").groups, FusedSAMBank(
        tc, freqs, wide_groups=2, device="cpu").groups) == (8, 2)
    assert FusedSAMBank(tc, freqs[:384], device="cpu").route == "lanes"   # 3 lane groups
    assert FusedSAMBank(tc, freqs[:200], device="cpu").groups == 2
    with pytest.raises(ValueError, match="does not divide"):
        FusedSAMBank(tc, freqs[:384], wide_groups=2, device="cpu")


def _chain_args(c=2, n=256, nb=False):
    f = torch.zeros
    args = [f(c, n), f(c, n), f(c, dtype=torch.int64), f(c, dtype=torch.int64),
            f(512, 256), f(256, 256), f(c, 128), f(c, 128), f(c, 128),
            torch.full((c,), 1e-6), f(c, 2), f(2, c), 1.0, 1.0, 1.0]
    if nb:
        args += [False, 1.0, 1.0, 1.0, True, 10.0, 512.0, f(c), torch.ones(c, 128)]
    return args


@pytest.mark.parametrize("fn", [sweep.sweep_sam_chain, sam_wide.sweep_sam_wide])
@pytest.mark.parametrize("index, bad", [
    (4, torch.zeros(512, 128)),    # w_sb is (512, 256)
    (11, torch.zeros(3, 2)),       # pll0 is (2, C)
    (23, None),                    # nb=True needs the carries
])
def test_chain_wrappers_reject_bad_arguments(fn, index, bad):
    args = _chain_args(nb=index > 20)
    args[index] = bad
    with pytest.raises(ValueError):
        fn(*args)


def test_cpu_tensors_never_launch():
    before = (sweep.LAUNCHES_SAM, sweep.LAUNCHES_SAM_NB, sam_wide.LAUNCHES,
              sam_wide.LAUNCHES_NB)
    assert len(sweep.sweep_sam_chain(*_chain_args())) == 6
    assert len(sweep.sweep_sam_chain(*_chain_args(nb=True))) == 8
    assert len(sam_wide.sweep_sam_wide(*_chain_args(), groups=4)) == 6
    assert len(sam_wide.sweep_sam_wide(*_chain_args(nb=True), groups=2)) == 8
    assert (sweep.LAUNCHES_SAM, sweep.LAUNCHES_SAM_NB, sam_wide.LAUNCHES,
            sam_wide.LAUNCHES_NB) == before
    with pytest.raises(ValueError, match="groups"):
        sam_wide.sweep_sam_wide(*_chain_args(), groups=3)
