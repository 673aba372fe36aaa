"""The port's ``make_full_sharded_chain`` on the CPU vs the JAX one.

A channel=2 x time=4 mesh on both sides: eight virtual CPU devices for JAX
(tests/conftest.py), ``[torch.device("cpu")] * 8`` for the port. The fifteen
mode x NR x blanker combos of ``__graft_entry__.dryrun_multichip`` run on 8
channels x 2048 samples (4 shards of 512), from a mid-stream state (one
segment threaded first), and the output and every leaf of the state after
it are held to the JAX chain at 1e-5 (f32; the products, scans and seam
fix-ups round in another order), 2e-4 with an LMS stage (its 96-tap sums
run in another order and the adaptation carries that, the LMS twin bound of
tests/test_pallas_lms.py:35). Mid-stream resume: two threaded segments
equal one unbroken run of both (2e-3, the bound of tests/test_parallel.py:
293; the seams reassociate the recurrences' sums), and the port's sharded
chain equals the port's unsharded chain (the same stages, ``ReceiverBank``
operators, one device) at 2e-3.
"""

import functools

import numpy as np
import pytest
import torch
import jax

from radiodsp_sdr_rx_tpu.models.config import AGCMode as JAGC
from radiodsp_sdr_rx_tpu.models.config import DemodMode as JDM
from radiodsp_sdr_rx_tpu.models.config import ReceiverConfig as JCfg
from radiodsp_sdr_rx_tpu.models.receiver import build_params as jax_build_params
from radiodsp_sdr_rx_tpu.parallel import make_mesh as jax_make_mesh
from radiodsp_sdr_rx_tpu.parallel.stream_shard import make_full_sharded_chain as jax_chain
from radiodsp_sdr_rx_tpu.parallel.stream_shard import sharded_chain_init as jax_init
from radiodsp_sdr_rx_tpu_torch.models.config import AGCMode, DemodMode, ReceiverConfig
from radiodsp_sdr_rx_tpu_torch.models.receiver import build_params
from radiodsp_sdr_rx_tpu_torch.parallel import make_mesh
from radiodsp_sdr_rx_tpu_torch.parallel.stream_shard import (
    ShardedChainState, make_full_sharded_chain, sharded_chain_init)
from radiodsp_sdr_rx_tpu_torch.utils import convert

FS = 44117.64706
MU = 0.0316
C, T_LOC, TDIM = 8, 256, 4
N = T_LOC * TDIM
ATOL, LMS_ATOL = 1e-5, 2e-4

COMBOS = [(m, r, False) for m in ("usb", "am", "sam")
          for r in ("off", "lms", "notch", "spectral")]
COMBOS += [("usb", "off", True), ("usb", "lms", True), ("sam", "off", True)]


def _params(jax_side: bool):
    kw = dict(vfo_freq=7_200_000.0, capture_center_freq=7_190_000.0, iq_gain_balance=1.0)
    p = (jax_build_params(JCfg(mode=JDM.USB, agc=JAGC.FAST, **kw)) if jax_side
         else build_params(ReceiverConfig(mode=DemodMode.USB, agc=AGCMode.FAST, **kw)))
    return (p.w_sideband, p.w_audio, p.agc_release, p.agc_target, p.agc_max_gain,
            p.agc_enabled, p.output_gain)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    incs = np.asarray([np.uint32(k * 977 + 12345) * np.uint32(65536) for k in range(C)],
                      np.uint32)
    iq = ((rng.standard_normal((C, 2 * N)) + 1j * rng.standard_normal((C, 2 * N)))
          * 0.2).astype(np.complex64)
    return iq, incs


@functools.lru_cache(maxsize=None)
def _jax_run(mode, nr, nb):
    """JAX: two threaded segments; the state after each."""
    chain = jax_chain(jax_make_mesh(channel=2, time=TDIM), mode=mode, nr=nr, sample_rate=FS,
                      lms_mu=MU, nr_level=30.0, noise_blanker=nb)
    iq, incs = _inputs()
    st, outs, states = jax_init(C), [], []
    for seg in range(2):
        a, st = chain(iq[:, seg * N:(seg + 1) * N], incs, st, *_params(True))
        outs.append(np.asarray(a))
        states.append(jax.tree.map(np.asarray, st))
    return outs, states


def _port_chain(mode, nr, nb):
    mesh = make_mesh(channel=2, time=TDIM, devices=[torch.device("cpu")] * 8)
    return make_full_sharded_chain(mesh, mode=mode, nr=nr, sample_rate=FS, lms_mu=MU,
                                   nr_level=30.0, noise_blanker=nb)


def _assert_state(got: ShardedChainState, want, atol):
    d = convert.state_to_numpy(got)
    w = want._asdict()
    np.testing.assert_array_equal(d["nco_phase"], w["nco_phase"])
    np.testing.assert_array_equal(d["lms"]["first"], np.asarray(w["lms"].first))
    for field in ("sb_tail", "audio_tail", "am_dc", "spec_tail_l", "spec_tail_r"):
        np.testing.assert_allclose(d[field], w[field], atol=atol, rtol=0, err_msg=field)
    for field in ("agc_env", "nb_avg", "nfloor", "sam_freq"):
        np.testing.assert_allclose(d[field], w[field], rtol=1e-4, atol=1e-9, err_msg=field)
    dp = np.abs(np.angle(np.exp(1j * (d["sam_phase"] - w["sam_phase"]))))
    assert dp.max() <= 1e-4, "sam_phase"
    for field in ("weights", "window", "delay"):
        np.testing.assert_allclose(d["lms"][field], np.asarray(getattr(w["lms"], field)),
                                   atol=atol, rtol=0, err_msg=field)


@pytest.mark.parametrize("mode, nr, nb", COMBOS,
                         ids=[f"{m}-{r}{'-nb' if b else ''}" for m, r, b in COMBOS])
def test_full_sharded_chain_matches_jax_from_a_midstream_state(mode, nr, nb):
    want, jstates = _jax_run(mode, nr, nb)
    atol = LMS_ATOL if nr in ("lms", "notch") else ATOL
    chain = _port_chain(mode, nr, nb)
    iq, incs = _inputs()
    st = convert.state_from_numpy(jstates[0]._asdict(), "cpu")
    assert isinstance(st, ShardedChainState) and st.sb_tail.dtype == torch.complex64
    audio, st = chain(iq[:, N:], incs, st, *_params(False))
    assert audio.shape == (C, N) and bool(torch.isfinite(audio).all())
    np.testing.assert_allclose(audio.numpy(), want[1], atol=atol, rtol=0)
    _assert_state(st, jstates[1], atol)


def test_full_sharded_chain_midstream_resume_and_unsharded():
    """Split == unbroken (USB + DNR, the adaptive stage's state crossing the
    seam), and the sharded chain == the same chain on a 1 x 1 mesh."""
    iq, incs = _inputs(11)
    chain = _port_chain("usb", "lms", False)
    full, _ = chain(iq, incs, sharded_chain_init(C), *_params(False))
    st = sharded_chain_init(C)
    a1, st = chain(iq[:, :N], incs, st, *_params(False))
    a2, _ = chain(iq[:, N:], incs, st, *_params(False))
    np.testing.assert_allclose(torch.cat([a1, a2], dim=1).numpy(), full.numpy(), atol=2e-3)
    one = make_full_sharded_chain(make_mesh(devices=[torch.device("cpu")]), mode="usb",
                                  nr="lms", sample_rate=FS, lms_mu=MU)
    ref, _ = one(iq, incs, sharded_chain_init(C), *_params(False))
    np.testing.assert_allclose(full.numpy(), ref.numpy(), atol=2e-3)


def test_full_sharded_chain_rejects_what_jax_rejects():
    mesh = make_mesh(channel=2, time=TDIM, devices=[torch.device("cpu")] * 8)
    with pytest.raises(ValueError):
        make_full_sharded_chain(mesh, mode="fm")
    with pytest.raises(ValueError):
        make_full_sharded_chain(mesh, nr="dnr")
    iq, incs = _inputs()
    chain = make_full_sharded_chain(mesh, nr="notch")
    with pytest.raises(ValueError, match="C / channel"):   # 6 / 2 = 3 channels on 4 shards
        chain(iq[:6, :N], incs[:6], sharded_chain_init(6), *_params(False))
