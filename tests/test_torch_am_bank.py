"""The port's AM path on the CPU vs the JAX package.

  - ``ops/iir.first_order_iir``, ``dc_blocker`` and ``planar.demod_am_planar``
    against the JAX functions (associative scans): <= 1e-6, the rounding of
    two summation orders of one f32 scan.
  - ``sweep_am_chain_plain`` (with and without the blanker, AGC MEDIUM and
    OFF) against the JAX ``sweep_am_chain`` in Pallas interpret mode over two
    threaded segments: <= 1e-4, the sweep chain's bound (test_torch_sweep.py).
  - ``FusedAMBank`` against the JAX ``FusedAMBank(interpret=True)`` (<= 1e-4)
    and against the XLA ``ReceiverBank(mode=AM)``: <= 2e-3, the
    docs/CHIP_PARITY.md bound, with the measured value (1.5e-7 on the AM
    scene, 7.5e-9 on the impulse scene) asserted under 1e-5: the port
    computes in fp32 throughout, so a jump of orders of magnitude would be a
    fault.

Carries that are copies of the input (``sb_tail``, the DDS phase, the keep
mask) are compared bit for bit; ``am_dc`` is computed from the band-pass
product, which the two packages sum in another order, so it is held to
1e-6 against JAX and bit for bit through the state conversion.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from radiodsp_sdr_rx_tpu.models import config as jcfg
from radiodsp_sdr_rx_tpu.models.fused import FusedAMBank as JaxFusedAMBank
from radiodsp_sdr_rx_tpu.models.fused import FusedAMBankState as JaxFusedAMBankState
from radiodsp_sdr_rx_tpu.models.receiver import ReceiverBank
from radiodsp_sdr_rx_tpu.models.receiver import build_params as jax_build_params
from radiodsp_sdr_rx_tpu.ops import iir as jax_iir
from radiodsp_sdr_rx_tpu.ops import planar as jax_planar
from radiodsp_sdr_rx_tpu.ops.pallas_sweep import sweep_am_chain as jax_sweep_am
from radiodsp_sdr_rx_tpu_torch.models import config as tcfg
from radiodsp_sdr_rx_tpu_torch.models.fused import FusedAMBank, FusedAMBankState
from radiodsp_sdr_rx_tpu_torch.ops import iir, planar, sweep
from radiodsp_sdr_rx_tpu_torch.utils import convert

N_CH, N = 8, 4096
CENTER = 7_050_000.0
FREQS = [CENTER + 1_000.0 * k for k in range(N_CH)]
FS = 44117.64706
SCAN_ATOL = 1e-6
ATOL = 1e-4
BANK_ATOL = 2e-3
BANK_MEASURED = 1e-5


def _configs(agc="OFF", **extra):
    kw = dict(vfo_freq=7_060_000.0, capture_center_freq=CENTER, **extra)
    return (jcfg.ReceiverConfig(mode=jcfg.DemodMode.AM, agc=jcfg.AGCMode[agc], **kw),
            tcfg.ReceiverConfig(mode=tcfg.DemodMode.AM, agc=tcfg.AGCMode[agc], **kw))


def _am_scene(rng, n, c=N_CH):
    """Noise with a burst, plus an AM station (700 Hz tone, 50% deep) that
    channel 3 tunes to DC: the DC blocker has a carrier to remove."""
    t = np.arange(n) / FS
    iq = (rng.standard_normal((c, n)) + 1j * rng.standard_normal((c, n))) * 0.1
    iq[:, n // 2:n // 2 + 300] *= 10.0
    iq += 0.3 * (1 + 0.5 * np.cos(2 * np.pi * 700.0 * t)) * np.exp(2j * np.pi * 3_000.0 * t)
    return iq.astype(np.complex64)


def _clip_for_nb(iq, cap_ratio=2.2):
    """Clip the noise magnitude to cap_ratio x its mean, so that no sample lies
    within rounding of the blanking threshold (tests/test_fused_bank.py:484)."""
    mag = np.abs(iq)
    cap = cap_ratio * float(mag.mean())
    return (iq * np.minimum(1.0, cap / np.maximum(mag, 1e-12))).astype(np.complex64)


def _nb_scene(rng, n, c=N_CH):
    iq = _clip_for_nb((rng.standard_normal((c, 2 * n))
                       + 1j * rng.standard_normal((c, 2 * n))) * 0.05)
    for pos in (500, 1733, n - 3, n - 1, n + 901):   # incl. the segment's last sample
        iq[:, pos] = 8.0 * (1 + 1j)
    return iq


def _t(a, dtype=torch.float32):
    a = np.array(a)
    return torch.as_tensor(a.astype(np.int64) if dtype is torch.int64 else a, dtype=dtype)


@pytest.mark.parametrize("a, b, shape, scale", [
    (0.995, 1.0, (3, 1000), 0.05),          # the DC blocker on envelope steps
    (0.998049, 0.001951, (5, 4096), 0.3),   # the blanker's mean magnitude, tau 512
    (0.5, 2.0, (17,), 1.0),                 # a 1-D stream, a fast pole
])
def test_first_order_iir_matches_jax(a, b, shape, scale):
    """At the magnitudes the chain feeds (outputs of order 1: the tolerance is
    absolute, a few f32 ulps of the running sum)."""
    rng = np.random.default_rng(len(shape) + shape[-1])
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    if b < 1.0:
        x = np.abs(x)                       # a magnitude
    y0 = (rng.standard_normal(shape[:-1]) * scale).astype(np.float32)
    want, want_last = jax_iir.first_order_iir(jnp.asarray(x), a, b, jnp.asarray(y0))
    got, got_last = iir.first_order_iir(_t(x), a, b, _t(y0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SCAN_ATOL, rtol=0)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last), atol=SCAN_ATOL, rtol=0)


@pytest.mark.parametrize("pole", [0.995, 0.9])
def test_dc_blocker_matches_jax(pole):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4, 2048)) * 0.05 + 0.6).astype(np.float32)   # an envelope
    y0 = (rng.standard_normal((4, 2)) * 0.05).astype(np.float32)
    want, want_c = jax_iir.dc_blocker(jnp.asarray(x), jnp.asarray(y0), pole)
    got, got_c = iir.dc_blocker(_t(x), _t(y0), pole)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SCAN_ATOL, rtol=0)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=SCAN_ATOL, rtol=0)
    assert np.array_equal(got_c.numpy()[:, 0], x[:, -1])   # the last input, copied


def test_demod_am_planar_matches_jax():
    rng = np.random.default_rng(9)
    zr, zi = (rng.standard_normal((2, 6, 1024)) * 0.3).astype(np.float32)
    dc = np.zeros((6, 2), np.float32)
    for _ in range(2):   # two threaded segments
        want, want_dc = jax_planar.demod_am_planar(jnp.asarray(zr), jnp.asarray(zi),
                                                   jnp.asarray(dc))
        got, got_dc = planar.demod_am_planar(_t(zr), _t(zi), _t(dc))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SCAN_ATOL, rtol=0)
        np.testing.assert_allclose(got_dc.numpy(), np.asarray(want_dc), atol=SCAN_ATOL, rtol=0)
        dc = np.asarray(want_dc)


@pytest.mark.parametrize("agc, nb", [
    ("MEDIUM", False), ("OFF", False), ("MEDIUM", True), ("OFF", True),
])
def test_am_chain_plain_matches_jax_interpret(agc, nb):
    jc, _ = _configs(agc)
    p = jax_build_params(jc)
    rng = np.random.default_rng(31 + 2 * nb + (agc == "OFF"))
    c, n = N_CH, N
    iq = _nb_scene(rng, n) if nb else np.concatenate([_am_scene(rng, n)] * 2, axis=1)
    inc = rng.integers(0, 2**32, c, dtype=np.uint64).astype(np.uint32)
    phase = rng.integers(0, 2**32, c, dtype=np.uint64).astype(np.uint32)
    kw = dict(agc_release=float(p.agc_release), agc_target=float(p.agc_target),
              agc_max_gain=float(p.agc_max_gain), agc_enabled=bool(p.agc_enabled),
              out_gain=0.5, in_gain=1.0, iq_balance=1.02, nb=nb,
              nb_thresh_db=10.0, nb_tau=256.0)
    tails = np.zeros((c, 256), np.float32)
    atail = np.zeros((c, 128), np.float32)
    env = np.full(c, 1e-6, np.float32)
    dc = np.zeros((c, 2), np.float32)
    nb_avg = np.full(c, float(np.abs(iq).mean()), np.float32)   # warm start
    nb_mask = np.ones((c, 128), np.float32)
    for seg in range(2):
        xr = np.ascontiguousarray(iq.real[:, seg * n:(seg + 1) * n], np.float32)
        xi = np.ascontiguousarray(iq.imag[:, seg * n:(seg + 1) * n], np.float32)
        nb_kw = dict(nb_avg0=nb_avg, nb_mask0=nb_mask) if nb else {}
        want = jax_sweep_am(xr, xi, inc, phase, p.w_sideband, p.w_pbt, tails[:, :128],
                            tails[:, 128:], atail, env, dc, chunk_t=2048,
                            interpret=True, **nb_kw, **kw)
        got = sweep.sweep_am_chain(
            _t(xr), _t(xi), _t(inc, torch.int64), _t(phase, torch.int64),
            _t(p.w_sideband), _t(p.w_pbt), _t(tails[:, :128]), _t(tails[:, 128:]),
            _t(atail), _t(env), _t(dc), **{k: _t(v) for k, v in nb_kw.items()}, **kw)
        assert len(got) == (7 if nb else 5)
        for g, w in zip(got, want):
            assert g.shape == tuple(np.shape(w))
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
        np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), atol=SCAN_ATOL, rtol=0)
        if nb:
            assert np.array_equal(got[6].numpy(), np.asarray(want[6]))
            if seg == 0:   # the last sample was blanked, and its mask carries
                assert got[6].numpy()[:, -1].max() == 0.0
        atail, env, dc = (np.asarray(w) for w in want[2:5])
        if nb:
            nb_avg, nb_mask = np.asarray(want[5]), np.asarray(want[6])
        tails = np.concatenate([xr[:, -128:], xi[:, -128:]], axis=1)
        phase = (phase.astype(np.uint64) + n * inc.astype(np.uint64)).astype(np.uint32)


def _warm_nb(iq, st_j, st_t):
    warm = np.full(st_j.nb_avg.shape, float(np.abs(iq).mean()), np.float32)
    return st_j._replace(nb_avg=warm), st_t._replace(nb_avg=torch.from_numpy(warm.copy()))


@pytest.mark.parametrize("agc, nb", [("OFF", False), ("MEDIUM", False), ("MEDIUM", True)])
def test_bank_matches_jax_fused_am_bank(agc, nb):
    jc, tc = _configs(agc, noise_blanker=nb, nb_tau_samples=256.0)
    jax_bank = JaxFusedAMBank(jc, FREQS, block_t=2048, interpret=True)
    port = FusedAMBank(tc, FREQS, device="cpu")
    rng = np.random.default_rng(41)
    iq = _nb_scene(rng, N) if nb else np.concatenate([_am_scene(rng, N)] * 2, axis=1)
    jst, st = jax_bank.init_state(), port.init_state()
    if nb:
        jst, st = _warm_nb(iq, jst, st)
    for seg in range(2):
        x = iq[:, seg * N:(seg + 1) * N]
        want, jst = jax_bank.process(x, jst)
        got, st = port.process(x, st)
        for key in ("audio_l", "audio_r"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       atol=ATOL, rtol=0)
        d = convert.state_to_numpy(st)
        for name in ("nco_phase", "sb_tail", "nb_mask"):
            np.testing.assert_array_equal(d[name], np.asarray(getattr(jst, name)))
        np.testing.assert_allclose(d["am_dc"], np.asarray(jst.am_dc), atol=SCAN_ATOL, rtol=0)
        np.testing.assert_allclose(d["agc_env"], np.asarray(jst.agc_env), rtol=1e-5)
        np.testing.assert_allclose(d["nb_avg"], np.asarray(jst.nb_avg), rtol=1e-5)


@pytest.mark.parametrize("nb", [False, True])
def test_bank_matches_receiver_bank(nb):
    jc, tc = _configs("OFF", noise_blanker=nb, nb_tau_samples=256.0)
    ref = ReceiverBank(jc, FREQS)
    port = FusedAMBank(tc, FREQS, device="cpu")
    rng = np.random.default_rng(43)
    iq = _nb_scene(rng, N) if nb else np.concatenate([_am_scene(rng, N)] * 2, axis=1)
    st_ref, st = ref.init_state(), port.init_state()
    if nb:
        st_ref, st = _warm_nb(iq, st_ref, st)
    worst = 0.0
    for seg in range(2):
        x = iq[:, seg * N:(seg + 1) * N]
        want, st_ref = ref.process(x, st_ref)
        got, st = port.process(x, st)
        for key in ("audio_l", "audio_r"):
            w = np.asarray(want[key])
            np.testing.assert_allclose(got[key].numpy(), w, atol=BANK_ATOL, rtol=0)
            worst = max(worst, float(np.abs(got[key].numpy() - w).max()))
    np.testing.assert_allclose(st.am_dc.numpy(), np.asarray(st_ref.am_dc), atol=SCAN_ATOL, rtol=0)
    assert worst < BANK_MEASURED


def test_streaming_continuity():
    _, tc = _configs("MEDIUM")
    port = FusedAMBank(tc, FREQS, device="cpu")
    iq = _am_scene(np.random.default_rng(5), 2 * N)
    whole, _ = port.process(iq, port.init_state())
    first, st = port.process(iq[:, :N], port.init_state())
    second, _ = port.process(iq[:, N:], st)
    for key in ("audio_l", "audio_r"):
        got = torch.cat([first[key], second[key]], dim=1)
        np.testing.assert_allclose(got.numpy(), whole[key].numpy(), atol=1e-5, rtol=0)


def test_jax_state_continues_in_port():
    """A stream started in the JAX bank continues in the port from the JAX
    state (utils/convert.py), and the port's state goes back bit for bit."""
    jc, tc = _configs("MEDIUM", noise_blanker=True, nb_tau_samples=256.0)
    jax_bank = JaxFusedAMBank(jc, FREQS, block_t=1024, interpret=True)
    port = FusedAMBank(tc, FREQS, device="cpu")
    iq = _nb_scene(np.random.default_rng(8), N)
    jst, _ = _warm_nb(iq, jax_bank.init_state(), port.init_state())
    _, jst = jax_bank.process(iq[:, :N], jst)
    st = convert.state_from_numpy({k: np.asarray(v) for k, v in jst._asdict().items()}, "cpu")
    assert isinstance(st, FusedAMBankState)
    want, jst = jax_bank.process(iq[:, N:], jst)
    got, st = port.process(iq[:, N:], st)
    for key in ("audio_l", "audio_r"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL, rtol=0)
    back = convert.state_to_numpy(st)
    again = convert.state_from_numpy(JaxFusedAMBankState(**back)._asdict(), "cpu")
    for name in st._fields:
        assert torch.equal(getattr(again, name), getattr(st, name)), name


@pytest.mark.parametrize("cfg_kw", [
    {"mode": tcfg.DemodMode.USB},
    {"mode": tcfg.DemodMode.SAM},
    {"nr": tcfg.NRMode.DNR2},
])
def test_rejects_configs_outside_the_bank(cfg_kw):
    _, tc = _configs()
    with pytest.raises(ValueError):
        FusedAMBank(tc.with_(**cfg_kw), FREQS, device="cpu")


def _args(c=2, n=256, nb=False):
    f = torch.zeros
    args = [f(c, n), f(c, n), f(c, dtype=torch.int64), f(c, dtype=torch.int64),
            f(512, 256), f(256, 256), f(c, 128), f(c, 128), f(c, 128),
            torch.full((c,), 1e-6), f(c, 2), 1.0, 1.0, 1.0]
    if nb:   # agc_enabled, out gain, the gains, then the blanker's
        args += [False, 1.0, 1.0, 1.0, True, 10.0, 512.0, f(c), torch.ones(c, 128)]
    return args


@pytest.mark.parametrize("index, bad", [
    (4, torch.zeros(512, 128)),                 # w_sb is (512, 256)
    (10, torch.zeros(2, 3)),                    # dc0 shape
    (11, 1.5),                                  # agc_release outside (0, 1]
    (21, None),                                 # nb=True needs the carries
])
def test_wrapper_rejects_bad_arguments(index, bad):
    args = _args(nb=index >= 14)
    args[index] = bad
    with pytest.raises(ValueError):
        sweep.sweep_am_chain(*args)


def test_cpu_tensors_never_launch():
    before = (sweep.LAUNCHES_AM, sweep.LAUNCHES_AM_NB)
    assert len(sweep.sweep_am_chain(*_args())) == 5
    assert len(sweep.sweep_am_chain(*_args(nb=True))) == 7
    assert (sweep.LAUNCHES_AM, sweep.LAUNCHES_AM_NB) == before
