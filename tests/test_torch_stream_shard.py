"""The port's time-sharded building blocks and 1-D/2-D chains on the CPU vs
the JAX package.

Both sides run on an 8-shard line (JAX: the 8 virtual CPU devices of
tests/conftest.py under ``shard_map``; the port: ``[torch.device("cpu")] *
8``) on the same numpy inputs. Held at 1e-5 (f32 on both sides; products,
scans and the seam fix-ups round in another order; the AGC envelope, whose
log/exp algebra rounds relative to its value, at rtol 1e-5): the sharded
overlap-save, first-order IIR and AGC envelope; ``make_time_sharded_ssb_chain``
for USB and AM with both halos (the K9 kernel's plain version here) against
the JAX ppermute chain; ``make_bank_time_sharded_chain`` on channel=2 x
time=4; ``sharded_panadapter``. The time-sharded USB chain also equals the
port's unsharded ``Receiver`` at 2e-3, as tests/test_parallel.py:377-396
holds the JAX one.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from radiodsp_sdr_rx_tpu.models.config import AGCMode as JAGC
from radiodsp_sdr_rx_tpu.models.config import DemodMode as JDM
from radiodsp_sdr_rx_tpu.models.config import ReceiverConfig as JCfg
from radiodsp_sdr_rx_tpu.models.receiver import build_params as jax_build_params
from radiodsp_sdr_rx_tpu.ops import fir_design as jax_fir
from radiodsp_sdr_rx_tpu import parallel as jpar
from radiodsp_sdr_rx_tpu_torch.models.config import AGCMode, DemodMode, ReceiverConfig
from radiodsp_sdr_rx_tpu_torch.models.receiver import Receiver, build_params
from radiodsp_sdr_rx_tpu_torch.ops import fir_design
from radiodsp_sdr_rx_tpu_torch.parallel import (
    make_bank_time_sharded_chain, make_mesh, make_time_sharded_ssb_chain,
    sharded_agc_envelope, sharded_first_order_iir, sharded_overlap_save, sharded_panadapter)
from radiodsp_sdr_rx_tpu_torch.utils import siggen

FS = 44117.64706
S = 8
CPU8 = [torch.device("cpu")] * S
ATOL = 1e-5


def _line():
    coords, axis = make_mesh(time=S, devices=CPU8).lines("time")
    return axis


def _jax_line(local, *args, specs=None):
    mesh = jpar.make_mesh(channel=1, time=S)
    f = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=specs or P(None, "time"),
                              out_specs=P(None, "time")))
    return np.asarray(f(*args))[0]


def _split(x):
    return [torch.from_numpy(p.copy()) for p in np.split(x, S, axis=-1)]


def test_sharded_overlap_save_matches_jax():
    rng = np.random.default_rng(0)
    mask = fir_design.design_filter_mask(300.0, 4000.0, FS)
    w = fir_design.overlap_save_matrix_real(mask)
    assert np.array_equal(w, jax_fir.overlap_save_matrix_real(
        jax_fir.design_filter_mask(300.0, 4000.0, FS)))
    x = (rng.standard_normal(S * 1024) + 1j * rng.standard_normal(S * 1024)).astype(np.complex64)
    first = (rng.standard_normal(128) + 1j * rng.standard_normal(128)).astype(np.complex64)

    def local(xs, ws):
        return jpar.sharded_overlap_save(xs, ws, jnp.asarray(first), "time")[0]

    want = _jax_line(local, x[None, :], jnp.asarray(w), specs=(P(None, "time"), P()))
    ys, tails = sharded_overlap_save(_split(x), torch.from_numpy(w), torch.from_numpy(first),
                                     _line())
    np.testing.assert_allclose(torch.cat(ys).numpy(), want, atol=ATOL, rtol=0)
    assert np.array_equal(tails[-1].numpy(), x[-128:])


def test_sharded_first_order_iir_matches_jax():
    x = np.random.default_rng(1).standard_normal(S * 2048).astype(np.float32)
    a, b, y0 = 0.999, 0.001, 0.7
    want = _jax_line(lambda xs: jpar.sharded_first_order_iir(xs, a, b, jnp.float32(y0), "time"),
                     x[None, :])
    got = sharded_first_order_iir(_split(x), a, b, torch.tensor(y0), _line())
    np.testing.assert_allclose(torch.cat(got).numpy(), want, atol=ATOL, rtol=0)


def test_sharded_agc_envelope_matches_jax():
    mag = np.abs(np.random.default_rng(2).standard_normal(S * 2048)).astype(np.float32)
    mag[5000:5100] *= 40.0
    want = _jax_line(lambda ms: jpar.sharded_agc_envelope(ms, 0.4, 0.9996, "time"),
                     mag[None, :])
    got = sharded_agc_envelope(_split(mag), 0.4, 0.9996, _line())
    np.testing.assert_allclose(torch.cat(got).numpy(), want, rtol=ATOL, atol=0)


def _usb_scene(n, am=False):
    if am:
        return siggen.am_signal(n, 10_000.0, mod_hz=900.0, fs=FS).astype(np.complex64)
    audio = siggen.voice_like(n, FS)
    return siggen.ssb_from_audio(audio, 10_000.0, FS, "usb", amp=0.4).astype(np.complex64)


def _cfgs(am):
    kw = dict(vfo_freq=7_060_000.0, capture_center_freq=7_050_000.0, iq_gain_balance=1.0)
    if am:
        return (JCfg(mode=JDM.AM, agc=JAGC.MEDIUM, **kw),
                ReceiverConfig(mode=DemodMode.AM, agc=AGCMode.MEDIUM, **kw))
    return (JCfg(mode=JDM.USB, agc=JAGC.FAST, **kw),
            ReceiverConfig(mode=DemodMode.USB, agc=AGCMode.FAST, **kw))


def _chain_args(p):
    return (p.nco_inc, p.w_sideband, p.w_audio, p.agc_release, p.agc_target, p.agc_max_gain,
            p.output_gain)


@pytest.mark.parametrize("am", [False, True], ids=["usb", "am"])
def test_time_sharded_chain_matches_jax_with_both_halos(am):
    jc, tc = _cfgs(am)
    iq = _usb_scene(S * 2048, am)
    want = np.asarray(jpar.make_time_sharded_ssb_chain(
        jpar.make_mesh(channel=1, time=S), am=am, sample_rate=FS)(
            jnp.asarray(iq), *_chain_args(jax_build_params(jc))))
    mesh = make_mesh(time=S, devices=CPU8)
    outs = {}
    for halo in ("ppermute", "kernel"):
        chain = make_time_sharded_ssb_chain(mesh, am=am, sample_rate=FS, halo=halo)
        outs[halo] = chain(iq, *_chain_args(build_params(tc))).numpy()
        np.testing.assert_allclose(outs[halo], want, atol=ATOL, rtol=0)
    assert np.array_equal(outs["kernel"], outs["ppermute"])


def test_time_sharded_usb_chain_equals_unsharded_receiver():
    _, tc = _cfgs(False)
    iq = _usb_scene(S * 4096)
    rx = Receiver(tc, device="cpu")
    single, _ = rx.process(iq, rx.init_state())
    chain = make_time_sharded_ssb_chain(make_mesh(time=S, devices=CPU8), sample_rate=FS,
                                        halo="kernel")
    audio = chain(iq, *_chain_args(build_params(tc)))
    np.testing.assert_allclose(audio.numpy(), single["audio_l"].numpy(), atol=2e-3)


def test_bank_time_sharded_chain_matches_jax():
    c, n = 4, 4 * 2048
    center = 7_050_000.0
    kw = dict(vfo_freq=center, capture_center_freq=center, iq_gain_balance=1.0)
    jp = jax_build_params(JCfg(mode=JDM.USB, agc=JAGC.MEDIUM, **kw))
    tp = build_params(ReceiverConfig(mode=DemodMode.USB, agc=AGCMode.MEDIUM, **kw))
    incs = np.asarray([np.uint32(k * 977 + 3) * np.uint32(65536) for k in range(c)], np.uint32)
    rng = np.random.default_rng(3)
    iq = ((rng.standard_normal((c, n)) + 1j * rng.standard_normal((c, n))) * 0.2
          ).astype(np.complex64)

    def args(p):
        return (p.w_sideband, p.w_audio, p.agc_release, p.agc_target, p.agc_max_gain,
                p.agc_enabled, p.output_gain)

    want = np.asarray(jpar.make_bank_time_sharded_chain(
        jpar.make_mesh(channel=2, time=4), sample_rate=FS)(jnp.asarray(iq), jnp.asarray(incs),
                                                           *args(jp)))
    got = make_bank_time_sharded_chain(make_mesh(channel=2, time=4, devices=CPU8),
                                       sample_rate=FS)(iq, incs, *args(tp))
    assert got.shape == (c, n)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_sharded_panadapter_matches_jax():
    n = S * 128 * 30
    iq = (siggen.carrier(n, 5000.0, FS, amp=0.4) + siggen.noise(n, 0.02, seed=4)
          ).astype(np.complex64)
    want = np.asarray(jpar.sharded_panadapter(jpar.make_mesh(channel=1, time=S),
                                              naverage=30)(jnp.asarray(iq)))
    got = sharded_panadapter(make_mesh(time=S, devices=CPU8), naverage=30)(iq).numpy()
    assert got.shape == want.shape == (1, 256)
    np.testing.assert_allclose(got, want, rtol=ATOL, atol=1e-3)
