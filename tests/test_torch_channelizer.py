"""The port's wideband front end against the JAX package on the CPU:
``ops/planar.frame_planar``, ``ops/decimate.py`` (the sliced operator and
the DDC), both polyphase channelizers of ``ops/channelizer.py``, and
``models/channelized.ChannelizedBank`` in its four demods at M = 8 and 16
over two threaded segments, with a JAX ``ChannelizedState`` carried into
the port. Same numpy inputs, from a seed. Modelled on
tests/test_decimate_channelizer.py and tests/test_channelized_bank.py.

Tolerances: the host-side designs (operators, prototype, phase words,
framing) are equal; the streams are held within TOL of the JAX ones (the
same fp32 products and scans, summed in another order; measured under
4e-7 on inputs of about 0.2-0.5); the SSB audio, after an AGC whose gain
reaches 316, within TOL_AGC (measured about 6e-6 at the AGC's 0.5 target),
the JAX test's bound for its own unaligned feed; ``buffer_remainder`` is
held to the aligned run of the port within the same bound.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from radiodsp_sdr_rx_tpu.models import channelized as jchannelized
from radiodsp_sdr_rx_tpu.ops import channelizer as jchannelizer
from radiodsp_sdr_rx_tpu.ops import decimate as jdecimate
from radiodsp_sdr_rx_tpu.ops import planar as jplanar
from radiodsp_sdr_rx_tpu_torch.models.channelized import ChannelizedBank, ChannelizedState
from radiodsp_sdr_rx_tpu_torch.ops import channelizer, decimate, planar
from radiodsp_sdr_rx_tpu_torch.utils import convert

FS = 44117.64706
TOL = 2e-6
TOL_AGC = 2e-5    # tests/test_channelized_bank.py:145
DEMODS = ("baseband", "am", "power", "ssb")


def _noise(rng, shape, scale=0.2):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * scale).astype(
        np.complex64)


def _planes(iq):
    return (np.ascontiguousarray(iq.real, np.float32), np.ascontiguousarray(iq.imag, np.float32))


def _close(got, want, tol=TOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_frame_planar_equals_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 1024)).astype(np.float32)
    tail = rng.standard_normal((3, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        planar.frame_planar(torch.from_numpy(x), torch.from_numpy(tail), 64).numpy(),
        np.asarray(jplanar.frame_planar(jnp.asarray(x), jnp.asarray(tail), 64)))


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_decimating_operator_and_design_equal_jax(factor):
    w = decimate.design_decimator(factor, FS)
    np.testing.assert_array_equal(w, jdecimate.design_decimator(factor, FS))
    assert w.shape == (512, 2 * 128 // factor)
    with pytest.raises(ValueError, match="not divisible"):
        decimate.decimating_operator(np.ones(256), 3)


@pytest.mark.parametrize("factor", [4, 8])
def test_ddc_over_two_threaded_segments_matches_jax(factor):
    """Two rows of a stream, each its own DDS word, two threaded segments;
    the second segment's phase words wrap past 2^32."""
    rng = np.random.default_rng(1)
    n = 4096
    xr, xi = _planes(_noise(rng, (2, 2 * n)))
    w = decimate.design_decimator(factor, FS)
    inc = np.array([987_654_321, 3_000_000_000], np.uint32)
    ph_j = np.array([4_000_000_000, 17], np.uint32)
    ph_t = torch.from_numpy(ph_j.astype(np.int64))
    tj = [jnp.zeros((2, 128), jnp.float32)] * 2
    tt = [torch.zeros(2, 128)] * 2
    wj, wt = jnp.asarray(w), torch.from_numpy(w)
    incj = jnp.asarray(inc)
    for seg in range(2):
        sl = slice(seg * n, (seg + 1) * n)
        yr_j, yi_j, ph_j, *tj = jax_ddc(xr[:, sl], xi[:, sl], ph_j, incj, wj, *tj)
        yr_t, yi_t, ph_t, *tt = decimate.ddc_planar(
            torch.from_numpy(xr[:, sl]), torch.from_numpy(xi[:, sl]), ph_t,
            torch.from_numpy(inc.astype(np.int64)), wt, *tt)
        assert tuple(yr_t.shape) == (2, n // factor)
        _close(yr_t, yr_j)
        _close(yi_t, yi_j)
        np.testing.assert_array_equal(ph_t.numpy().astype(np.uint32), np.asarray(ph_j))
        for a, b in zip(tt, tj):
            _close(a, b)


def jax_ddc(xr, xi, ph, inc, w, tail_r, tail_i):
    """The JAX DDC on a bank: its ddc_planar takes one DDS word a call."""
    outs = [jdecimate.ddc_planar(jnp.asarray(xr[c]), jnp.asarray(xi[c]), ph[c], inc[c], w,
                                 tail_r[c], tail_i[c]) for c in range(xr.shape[0])]
    return [jnp.stack([o[k] for o in outs]) for k in range(5)]


def test_decimating_filter_on_a_one_dimensional_stream_matches_jax():
    rng = np.random.default_rng(2)
    xr, xi = _planes(_noise(rng, 2048))
    w = decimate.design_decimator(4, FS)
    got = decimate.decimating_filter_planar(torch.from_numpy(xr), torch.from_numpy(xi),
                                            torch.from_numpy(w), torch.zeros(128),
                                            torch.zeros(128))
    want = jdecimate.decimating_filter_planar(jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(w),
                                              jnp.zeros(128), jnp.zeros(128))
    for a, b in zip(got, want):
        _close(a, b)


def test_design_prototype_equals_jax():
    for m, p in ((8, 8), (16, 4), (64, 8)):
        np.testing.assert_array_equal(channelizer.design_prototype(m, p, FS),
                                      jchannelizer.design_prototype(m, p, FS))


@pytest.mark.parametrize("kind", ["PFBChannelizer", "OversampledPFB"])
@pytest.mark.parametrize("m", [8, 16])
def test_pfb_over_two_threaded_segments_matches_jax(kind, m):
    rng = np.random.default_rng(3)
    n = 64 * m
    xr, xi = _planes(_noise(rng, 2 * n))
    jch = getattr(jchannelizer, kind)(m)
    tch = getattr(channelizer, kind)(m, device="cpu")
    np.testing.assert_array_equal(tch.h_poly, jch.h_poly)
    sj, st = jch.init_state(), tch.init_state()
    assert tuple(st.shape) == sj.shape and st.dtype == torch.float32
    for seg in range(2):
        sl = slice(seg * n, (seg + 1) * n)
        yr_j, yi_j, sj = jch(jnp.asarray(xr[sl]), jnp.asarray(xi[sl]), sj)
        yr_t, yi_t, st = tch(torch.from_numpy(xr[sl]), torch.from_numpy(xi[sl]), st)
        _close(yr_t, yr_j)
        _close(yi_t, yi_j)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_oversampled_pfb_flips_odd_channels_on_even_frames():
    """The twiddle (-1)^(k(t+1)) of the JAX channelizer, a sign flip of
    odd channels on even frames: the output equals JAX's, and would not
    without the flip, nor with the flip on odd frames."""
    rng = np.random.default_rng(4)
    ch = channelizer.OversampledPFB(8, device="cpu")
    xr, xi = _planes(_noise(rng, 512))
    yr, yi, _ = ch(torch.from_numpy(xr), torch.from_numpy(xi), ch.init_state())
    jr, ji, _ = jchannelizer.OversampledPFB(8)(jnp.asarray(xr), jnp.asarray(xi),
                                               jchannelizer.OversampledPFB(8).init_state())
    _close(yr, jr)
    _close(yi, ji)
    k, t = np.arange(8)[:, None], np.arange(yr.shape[-1])[None, :]
    for wrong in (0 * k * t, (k & 1) * (t & 1)):   # no flip; the flip on odd frames
        other = np.where(((k & 1) * ((t + 1) & 1)) != wrong, -yr.numpy(), yr.numpy())
        assert np.abs(other - np.asarray(jr)).max() > 100 * TOL
    with pytest.raises(ValueError, match="even"):
        channelizer.OversampledPFB(7, device="cpu")
    with pytest.raises(ValueError, match="multiple of M"):
        ch(torch.zeros(100), torch.zeros(100), ch.init_state())


def _banks(m, demod, rng, **kw):
    extra = {}
    if demod == "ssb":
        # offsets up to 0.45 of the channel rate: the residual DDS angle
        # ph + j*inc wraps in int32 within a segment
        extra = dict(offsets_hz=rng.uniform(-0.45, 0.45, m) * 2 * FS / m, agc="medium")
    return (jchannelized.ChannelizedBank(m, demod=demod, **extra, **kw),
            ChannelizedBank(m, demod=demod, device="cpu", **extra, **kw))


def _check_outputs(ot, oj, agc=False):
    assert set(ot) == set(oj)
    for k in oj:
        _close(ot[k], oj[k], TOL_AGC if agc and k == "audio" else TOL)


def _check_state(st, sj):
    assert isinstance(st, ChannelizedState)
    for name, got in convert.state_to_numpy(st).items():
        want = np.asarray(getattr(sj, name))
        assert got.dtype == want.dtype, name
        if name == "nco":
            np.testing.assert_array_equal(got, want)
        else:
            _close(got, want)


@pytest.mark.parametrize("demod", DEMODS)
@pytest.mark.parametrize("m", [8, 16])
def test_channelized_bank_over_two_threaded_segments_matches_jax(demod, m):
    rng = np.random.default_rng(5)
    jb, tb = _banks(m, demod, rng)
    n = 2 * tb.segment_multiple if demod == "ssb" else 64 * m
    iq = _noise(rng, 2 * n)
    sj, st = jb.init_state(), tb.init_state()
    _check_state(st, sj)
    for seg in range(2):
        oj, sj = jb.process(iq[seg * n:(seg + 1) * n], sj)
        ot, st = tb.process(torch.from_numpy(iq[seg * n:(seg + 1) * n]), st)
        _check_outputs(ot, oj, agc=demod == "ssb")
        _check_state(st, sj)
    if demod == "ssb":   # the int32 wrap of the angle happened in this run
        n_out = 2 * n // m
        words = (np.asarray(st.nco)[:, None].astype(np.int64) % 2**32
                 + np.arange(n_out) * tb._incs.astype(np.int64)[:, None])
        assert (words >= 2**31).any() and (words < 2**31).any()


def test_ssb_angle_wraps_in_int32_where_a_wider_sum_would_not():
    """The residual DDS: ph + j*inc read as int32 before the float
    conversion (JAX ``bitcast_convert_type``), so the angle is the wrapped
    word's, not ph + j*inc in a wider integer (which would leave the angle
    out of [-pi, pi) and lose float32 precision)."""
    m = 8
    offsets = np.full(m, 0.4 * 2 * FS / m)
    jb = jchannelized.ChannelizedBank(m, demod="ssb", offsets_hz=offsets)
    tb = ChannelizedBank(m, demod="ssb", offsets_hz=offsets, device="cpu")
    iq = _noise(np.random.default_rng(6), tb.segment_multiple)
    st = tb.init_state()._replace(nco=torch.full((m,), 2**32 - 5, dtype=torch.int64))
    sj = jb.init_state()._replace(nco=np.full(m, 2**32 - 5, np.uint32))
    ot, st = tb.process(iq, st)
    oj, sj = jb.process(iq, sj)
    _check_outputs(ot, oj, agc=True)
    _check_state(st, sj)


def test_jax_channelized_state_continues_in_the_port():
    rng = np.random.default_rng(7)
    jb, tb = _banks(8, "ssb", rng)
    n = tb.segment_multiple
    iq = _noise(rng, 3 * n)
    sj = jb.init_state()
    for seg in range(2):
        _, sj = jb.process(iq[seg * n:(seg + 1) * n], sj)
    st = convert.state_from_numpy(sj._asdict(), "cpu")
    assert isinstance(st, ChannelizedState) and st.nco.dtype == torch.int64
    oj, sj = jb.process(iq[2 * n:], sj)
    ot, st = tb.process(iq[2 * n:], st)
    _check_outputs(ot, oj, agc=True)
    _check_state(st, sj)


def test_segment_multiple_errors_match_jax():
    for demod, m, bad in (("am", 16, 100), ("ssb", 16, 512), ("power", 8, 12)):
        jb = jchannelized.ChannelizedBank(m, demod=demod)
        tb = ChannelizedBank(m, demod=demod, device="cpu")
        assert tb.segment_multiple == jb.segment_multiple
        with pytest.raises(ValueError) as want:
            jb.process(np.zeros(bad, np.complex64), jb.init_state())
        with pytest.raises(ValueError) as got:
            tb.process(np.zeros(bad, np.complex64), tb.init_state())
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="offsets_hz"):
        ChannelizedBank(8, demod="ssb", offsets_hz=np.zeros(3), device="cpu")
    with pytest.raises(ValueError, match="agc must be one of"):
        ChannelizedBank(8, demod="ssb", agc="turbo", device="cpu")
    tb = ChannelizedBank(16, demod="am", device="cpu")
    jb = jchannelized.ChannelizedBank(16, demod="am")
    assert [tb.channel_freq(k, 7e6) for k in (0, 3, 8, 15)] == [
        jb.channel_freq(k, 7e6) for k in (0, 3, 8, 15)]


@pytest.mark.parametrize("demod", ["ssb", "am"])
def test_buffer_remainder_matches_the_aligned_run(demod):
    """A feed cut at unaligned points: the outputs put together equal the
    aligned one-shot run; the tail waits as a tensor on the bank's device;
    a call with too few samples returns the JAX keys with shapes (M, 0)."""
    rng = np.random.default_rng(8)
    m = 8
    jb, aligned = _banks(m, demod, rng)
    offsets = getattr(aligned, "_incs", None)
    kw = {}
    if demod == "ssb":
        kw = dict(offsets_hz=jb._incs.astype(np.float64) / 2**32 * aligned.channel_rate,
                  agc="medium")
        aligned = ChannelizedBank(m, demod=demod, device="cpu", **kw)
    del offsets
    mult = aligned.segment_multiple
    n = max(4 * mult, 2048)
    iq = _noise(rng, n)
    out_f, _ = aligned.process(iq, aligned.init_state())

    bank = ChannelizedBank(m, demod=demod, device="cpu", buffer_remainder=True, **kw)
    st = bank.init_state()
    cuts = [0, 3, n // 4 + 5, n // 4 + 93, 3 * n // 4 + 17, n - n // 8 - 3]
    pieces = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        o, st = bank.process(iq[a:b], st)
        assert set(o) == set(out_f)
        pieces.append(o["audio"])
        if a == 0:   # fewer samples than a segment: nothing out yet
            assert all(tuple(o[k].shape) == (m, 0) for k in o if k != "power")
            assert o["power"] is st.power
    assert bank.pending_samples == cuts[-1] % mult > 0
    assert isinstance(bank._pending[0], torch.Tensor)
    o, st = bank.process(iq[cuts[-1]:], st)
    assert bank.pending_samples == 0
    got = torch.cat(pieces + [o["audio"]], dim=-1)
    _close(got, out_f["audio"], TOL_AGC)

    # the JAX bank on the same cuts gives the same empty keys
    jbank = jchannelized.ChannelizedBank(m, demod=demod, buffer_remainder=True, **kw)
    oj, _ = jbank.process(iq[:3], jbank.init_state())
    o, _ = bank.process(iq[:3], bank.init_state())
    assert set(o) == set(oj) and all(tuple(o[k].shape) == np.shape(oj[k]) for k in oj)
