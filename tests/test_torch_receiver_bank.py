"""The port's reference chain ``ReceiverBank`` on the CPU vs the JAX package.

Both port backends ("vmap" and "batched" run the one bank chain) against the
JAX ``ReceiverBank(backend="batched")`` (whose LMS stages run the Pallas
kernel in interpret mode), two threaded segments of 8 channels x 4096, for
the SSB modes and AM, NR off / notch / DNR2 / SPEC1-4, the noise blanker
(on the decisive impulse scene of tests/test_fused_bank.py:484-545), q15
output and mute: <= 1e-4 (both are f32; the products, scans and LMS sums
run in another order, and the AGC gain amplifies that). The measured max is
5.1e-7 (CW_NARROW + notch; the spectral cases 1.9e-7), and one q15 step
(3.05e-5) with ``quantize_output``, where a sample that rounding puts on
the other side of a truncation boundary lands one step away.
The planar stages are held to their JAX functions at the same bound, the
q15 round trip bit for bit. The conv-first variants and other fft_lengths
run (held to JAX in tests/test_torch_conv_first.py and
tests/test_torch_fft_length.py); SAM is held in tests/test_torch_sam.py.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from radiodsp_sdr_rx_tpu.models import config as jcfg
from radiodsp_sdr_rx_tpu.models.receiver import ReceiverBank as JaxReceiverBank
from radiodsp_sdr_rx_tpu.models.receiver import ReceiverState as JaxReceiverState
from radiodsp_sdr_rx_tpu.models.receiver import build_params as jax_build_params
from radiodsp_sdr_rx_tpu.ops import lms as jax_lms
from radiodsp_sdr_rx_tpu.ops import planar as jax_planar
from radiodsp_sdr_rx_tpu.ops.qformat import quantize_q15 as jax_q15
from radiodsp_sdr_rx_tpu_torch.models import config as tcfg
from radiodsp_sdr_rx_tpu_torch.models import receiver
from radiodsp_sdr_rx_tpu_torch.models.receiver import ReceiverBank, ReceiverState
from radiodsp_sdr_rx_tpu_torch.ops import planar, qformat
from radiodsp_sdr_rx_tpu_torch.utils import convert

ATOL = 1e-4
LMS_ATOL = 2e-4   # the LMS twin bound (tests/test_pallas_lms.py:35)
N_CH, N = 8, 4096

# (mode, nr, agc, extra config, vfo, capture centre)
CASES = {
    "usb": ("USB", "OFF", "MEDIUM", {}, 7_200_000.0, 7_190_000.0),
    "cw_narrow_notch": ("CW_NARROW", "NOTCH", "FAST", {}, 14_050_000.0, 14_049_000.0),
    "usb_dnr2": ("USB", "DNR2", "MEDIUM", {}, 7_200_000.0, 7_190_000.0),
    "am": ("AM", "OFF", "OFF", {}, 7_060_000.0, 7_050_000.0),
    "usb_nb": ("USB", "OFF", "MEDIUM", {"noise_blanker": True, "nb_tau_samples": 256.0},
               7_200_000.0, 7_190_000.0),
    "lsb_q15": ("LSB", "OFF", "SLOW", {"quantize_output": True}, 7_100_000.0, 7_110_000.0),
    "usb_mute": ("USB", "OFF", "MEDIUM", {"mute": True}, 7_200_000.0, 7_190_000.0),
    "usb_spec1": ("USB", "SPEC1", "MEDIUM", {}, 7_200_000.0, 7_190_000.0),
    "lsb_spec2": ("LSB", "SPEC2", "FAST", {}, 7_100_000.0, 7_110_000.0),
    "cw_spec3": ("CW", "SPEC3", "SLOW", {}, 14_050_000.0, 14_049_000.0),
    "am_spec4": ("AM", "SPEC4", "OFF", {}, 7_060_000.0, 7_050_000.0),
}


def _configs(name):
    mode, nr, agc, extra, vfo, center = CASES[name]
    kw = dict(vfo_freq=vfo, capture_center_freq=center, **extra)
    return (jcfg.ReceiverConfig(mode=jcfg.DemodMode[mode], nr=jcfg.NRMode[nr],
                                agc=jcfg.AGCMode[agc], **kw),
            tcfg.ReceiverConfig(mode=tcfg.DemodMode[mode], nr=tcfg.NRMode[nr],
                                agc=tcfg.AGCMode[agc], **kw))


def _freqs(name):
    center = CASES[name][5]
    return [center + 1_000.0 * k for k in range(N_CH)]


def _clip_for_nb(iq, cap_ratio=2.2):
    mag = np.abs(iq)
    cap = cap_ratio * float(mag.mean())
    return (iq * np.minimum(1.0, cap / np.maximum(mag, 1e-12))).astype(np.complex64)


def _scene(name):
    """Two segments (C, 2N): the impulse scene for the blanker, else noise
    with a burst and a tone that channel 2 receives."""
    rng = np.random.default_rng(sorted(CASES).index(name))
    if CASES[name][3].get("noise_blanker"):
        iq = _clip_for_nb((rng.standard_normal((N_CH, 2 * N))
                           + 1j * rng.standard_normal((N_CH, 2 * N))) * 0.05)
        for pos in (500, 1733, N - 3, N - 1, N + 901):
            iq[:, pos] = 8.0 * (1 + 1j)
        return iq
    t = np.arange(2 * N) / 44117.64706
    iq = (rng.standard_normal((N_CH, 2 * N)) + 1j * rng.standard_normal((N_CH, 2 * N))) * 0.1
    iq[:, N // 2:N // 2 + 400] *= 20.0
    iq += 0.2 * np.exp(2j * np.pi * (2_000.0 + 900.0) * t)
    return iq.astype(np.complex64)


def _warm(iq, st, name):
    if not CASES[name][3].get("noise_blanker"):
        return st
    warm = np.full((N_CH,), float(np.abs(iq).mean()), np.float32)
    if isinstance(st, ReceiverState):
        return st._replace(nb_avg=torch.from_numpy(warm))
    return st._replace(nb_avg=warm)


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """The JAX batched bank over the two segments: outputs and states."""
    jc, _ = _configs(name)
    bank = JaxReceiverBank(jc, _freqs(name), backend="batched")
    iq = _scene(name)
    st = _warm(iq, bank.init_state(), name)
    outs, states = [], [st]
    for seg in range(2):
        out, st = bank.process(iq[:, seg * N:(seg + 1) * N], st)
        outs.append({k: np.asarray(v) for k, v in out.items()})
        states.append(st)
    return outs, states


@pytest.mark.parametrize("backend", ["vmap", "batched"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_bank_matches_jax_batched_bank(name, backend):
    _, tc = _configs(name)
    port = ReceiverBank(tc, _freqs(name), backend=backend, device="cpu")
    iq = _scene(name)
    st = _warm(iq, port.init_state(), name)
    want, jstates = _jax_run(name)
    for seg in range(2):
        got, st = port.process(iq[:, seg * N:(seg + 1) * N], st)
        for key in ("audio_l", "audio_r"):
            np.testing.assert_allclose(got[key].numpy(), want[seg][key], atol=ATOL, rtol=0)
        d, jst = convert.state_to_numpy(st), jstates[seg + 1]
        np.testing.assert_array_equal(d["nco_phase"], np.asarray(jst.nco_phase))
        np.testing.assert_array_equal(d["lms"]["first"], np.asarray(jst.lms.first))
        for field in ("sb_tail_r", "sb_tail_i", "audio_tail", "am_dc", "spec_tail_l",
                      "spec_tail_r"):
            np.testing.assert_allclose(d[field], np.asarray(getattr(jst, field)), atol=ATOL, rtol=0)
        for field in ("weights", "window", "delay"):
            np.testing.assert_allclose(d["lms"][field], np.asarray(getattr(jst.lms, field)),
                                       atol=ATOL, rtol=0)
        np.testing.assert_allclose(d["agc_env"], np.asarray(jst.agc_env), rtol=1e-4)
        np.testing.assert_allclose(d["nb_avg"], np.asarray(jst.nb_avg), rtol=1e-4)
        np.testing.assert_allclose(d["nfloor"], np.asarray(jst.nfloor), rtol=1e-4)
    if CASES[name][3].get("mute"):
        assert not got["audio_l"].any() and not got["audio_r"].any()
    if CASES[name][3].get("quantize_output"):
        assert torch.equal(got["audio_l"], torch.round(got["audio_l"] * 32768) / 32768)
    if CASES[name][1] == "DNR2":
        assert torch.equal(got["audio_l"], got["audio_r"])


@pytest.mark.parametrize("name", ["usb_dnr2", "usb_nb", "cw_narrow_notch", "lsb_spec2"])
def test_jax_state_continues_in_port(name):
    """The JAX bank's state after segment 1, nested LMS and SAM states
    included, continues in the port (utils/convert.py); the port's state
    goes back to a JAX state, and round trips bit for bit."""
    _, tc = _configs(name)
    port = ReceiverBank(tc, _freqs(name), device="cpu")
    want, jstates = _jax_run(name)
    jst = jstates[1]
    st = convert.state_from_numpy(jst._asdict(), "cpu")
    assert isinstance(st, ReceiverState) and st.lms.first.dtype == torch.bool
    got, st = port.process(_scene(name)[:, N:], st)
    for key in ("audio_l", "audio_r"):
        np.testing.assert_allclose(got[key].numpy(), want[1][key], atol=ATOL, rtol=0)
    d = convert.state_to_numpy(st)
    back = JaxReceiverState(**{**d, "lms": jax_lms.LMSState(**d["lms"]),
                               "sam": jax_planar.SAMStatePlanar(**d["sam"])})
    again = convert.state_from_numpy(back, "cpu")
    flat = jax.tree_util.tree_leaves
    for a, b in zip(flat(tuple(again)), flat(tuple(st))):
        assert torch.equal(a, b)


def test_init_state_matches_jax_bank():
    jc, tc = _configs("usb")
    want = JaxReceiverBank(jc, _freqs("usb")).init_state()
    got = convert.state_to_numpy(ReceiverBank(tc, _freqs("usb"), device="cpu").init_state())
    assert set(got) == set(JaxReceiverState._fields)
    for name, w in want._asdict().items():
        if name in ("lms", "sam"):
            for field, leaf in w._asdict().items():
                np.testing.assert_array_equal(got[name][field], leaf)
                assert got[name][field].dtype == np.asarray(leaf).dtype
        else:
            np.testing.assert_array_equal(got[name], w)
            assert got[name].dtype == np.asarray(w).dtype


def test_params_match_jax():
    jc, tc = _configs("cw_narrow_notch")
    want, got = jax_build_params(jc), receiver.build_params(tc)
    assert got.lms_mu == want.lms_mu and got.lms_mu.dtype == np.float32
    assert _configs("usb_dnr2")[1].nr.level == 30
    assert receiver.build_params(_configs("usb_dnr2")[1]).lms_mu == \
        jax_build_params(_configs("usb_dnr2")[0]).lms_mu


def _planes(rng, c=4, n=1024, scale=0.3):
    return tuple((rng.standard_normal((c, n)) * scale).astype(np.float32) for _ in range(2))


def test_planar_stages_match_jax():
    rng = np.random.default_rng(12)
    p = jax_build_params(_configs("am")[0])
    xr, xi = _planes(rng)
    tr, ti = _planes(rng, n=128)
    t = torch.from_numpy
    pairs = []

    inc = rng.integers(0, 2**32, 4, dtype=np.uint64).astype(np.uint32)
    ph = rng.integers(0, 2**32, 4, dtype=np.uint64).astype(np.uint32)
    want = jax.vmap(jax_planar.nco_mix_planar)(xr, xi, ph, inc)
    got = planar.nco_mix_planar(t(xr), t(xi), t(ph.astype(np.int64)), t(inc.astype(np.int64)))
    pairs += list(zip(got[:2], want[:2]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]).astype(np.int64))

    want = jax_planar.overlap_save_filter_planar(xr, xi, p.w_sideband, tr, ti)
    got = planar.overlap_save_filter_planar(
        t(xr), t(xi), t(np.ascontiguousarray(p.w_sideband)), t(tr), t(ti))
    pairs += list(zip(got, want))
    want = jax_planar.ssb_filter_demod_planar(xr, xi, p.w_ssb, tr, ti)
    got = planar.ssb_filter_demod_planar(t(xr), t(xi), t(np.ascontiguousarray(p.w_ssb)),
                                         t(tr), t(ti))
    pairs += list(zip(got, want))
    want = jax_planar.pbt_filter_planar(xr, p.w_pbt, tr)
    got = planar.pbt_filter_planar(t(xr), t(np.ascontiguousarray(p.w_pbt)), t(tr))
    pairs += list(zip(got, want))
    want = jax_planar.iq_gain_balance_planar(xr, xi, np.float32(1.02))
    got = planar.iq_gain_balance_planar(t(xr), t(xi), 1.0199999809265137)
    pairs += list(zip(got, want))
    for g, w in pairs:
        assert g.shape == tuple(np.shape(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_noise_blanker_planar_matches_jax():
    iq = _scene("usb_nb")[:4, :N]
    xr, xi = np.ascontiguousarray(iq.real), np.ascontiguousarray(iq.imag)
    avg0 = np.full(4, float(np.abs(iq).mean()), np.float32)
    want = jax.jit(jax_planar.noise_blanker_planar)(xr, xi, avg0, np.float32(10.0),
                                                    np.float32(256.0))
    got = planar.noise_blanker_planar(torch.from_numpy(xr), torch.from_numpy(xi),
                                      torch.from_numpy(avg0), 10.0, 256.0)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy() == 0, np.asarray(w) == 0)   # same blanks
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
    assert (got[0].numpy() == 0).sum() >= 4 * 4               # the impulses went
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)


def test_q15_round_trip_matches_jax_bit_for_bit():
    rng = np.random.default_rng(2)
    f = np.concatenate([rng.standard_normal(4000).astype(np.float32) * 0.5,
                        np.float32([1.0, -1.0, 1.5, -1.5, 0.99999, -3.05e-5, 0.0])])
    got = qformat.quantize_q15(torch.from_numpy(f)).numpy()
    assert np.array_equal(got, np.asarray(jax_q15(jnp.asarray(f))))
    assert got.max() == 32767 / 32768 and got.min() == -1.0


@pytest.mark.parametrize("cfg_kw", [
    {"fft_length": 1024},
    {"conv_first": True},
    {"conv_first": True, "conv_inline_denoise": True},
    {"fft_length": 512},
])
def test_unported_stages_raise_not_implemented(cfg_kw):
    """The stages that raised NotImplementedError before they were ported
    now build and run: a segment of every such configuration gives finite
    audio, and ``check_ported`` raises only for a mode without a
    demodulator."""
    _, tc = _configs("usb")
    cfg = tc.with_(**cfg_kw)
    bank = ReceiverBank(cfg, _freqs("usb"), device="cpu")
    out, st = bank.process(_scene("usb")[:, :N], bank.init_state())
    assert all(bool(torch.isfinite(v).all()) and v.shape == (N_CH, N) for v in out.values())
    assert st.audio_tail.shape == (N_CH, cfg.fft_length // 2)
    receiver.check_ported(cfg.mode)
    with pytest.raises(ValueError, match="unsupported mode"):
        receiver.check_ported("FM")


def test_lms_stages_keep_the_channel_limit():
    """The batched backend keeps the JAX ``rx_chain_batched`` cap of 128
    channels with an LMS stage (the vmap backend has none, below)."""
    _, tc = _configs("usb_dnr2")
    bank = ReceiverBank(tc, [7_190_000.0 + 100.0 * k for k in range(129)],
                        backend="batched", device="cpu")
    x = np.zeros((129, 128), np.float32)
    with pytest.raises(ValueError, match="<= 128 channels"):
        bank.process_planar(x, x, bank.init_state())


def test_vmap_bank_runs_past_the_lms_channel_limit():
    """The vmap backend runs 129 channels with DNR2, as the JAX vmap bank
    does (it vmaps the per-channel chain, whose LMS is an XLA scan with no
    lane cap): two threaded segments of 512 samples held to the JAX vmap
    bank at the LMS bound 2e-4 (the 96-tap sums run in another order and
    the adaptation carries that), the LMS state included."""
    jc, tc = _configs("usb_dnr2")
    c, n = 129, 512
    freqs = [7_190_000.0 + 100.0 * k for k in range(c)]
    rng = np.random.default_rng(129)
    iq = ((rng.standard_normal((c, 2 * n)) + 1j * rng.standard_normal((c, 2 * n)))
          * 0.1).astype(np.complex64)
    jbank = JaxReceiverBank(jc, freqs, backend="vmap")
    port = ReceiverBank(tc, freqs, backend="vmap", device="cpu")
    jst, st = jbank.init_state(), port.init_state()
    for seg in range(2):
        block = iq[:, seg * n:(seg + 1) * n]
        want, jst = jbank.process(block, jst)
        got, st = port.process(block, st)
        for key in ("audio_l", "audio_r"):
            assert got[key].shape == (c, n)
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       atol=LMS_ATOL, rtol=0)
        d = convert.state_to_numpy(st)
        np.testing.assert_array_equal(d["lms"]["first"], np.asarray(jst.lms.first))
        for field in ("weights", "window", "delay"):
            np.testing.assert_allclose(d["lms"][field], np.asarray(getattr(jst.lms, field)),
                                       atol=LMS_ATOL, rtol=0)


def test_rejects_unknown_backend():
    _, tc = _configs("usb")
    with pytest.raises(ValueError):
        ReceiverBank(tc, _freqs("usb"), backend="xla", device="cpu")
