"""The exact SAM PLL's wrapper on the CPU: ``planar.demod_sam_planar`` and
``ops/demod.demod_sam`` against the JAX package.

``demod_sam_planar`` launches ``csrc/sam.cu``'s ``sam_exact`` for CUDA
tensors (held to the plain loop on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``); here, on CPU
tensors, it and ``sam_exact`` run their plain versions, count no launch,
and raise on any other device and on arguments the kernel does not take.
Against the JAX ``lax.scan`` on locked scenes (the PLL is chaotic on noise), over two threaded
halves whose length is no multiple of 128 (a CLI block, the appliance's
4,096, any n): the audio and the DC carry <= 1e-4, the phase <= 1e-4 on the
circle, the frequency <= 1e-5 (test_torch_sam.py's bounds: XLA and PyTorch
take the libm functions apart, and the loop carries that). ``demod_sam``'s
() carries, one (n,) stream as the JAX function takes it, go through the
wrapper as (1,) rows and come back as (); (C, n) streams with (C,) carries
are C such streams (<= 1e-6: a row alone may take another libm path).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from radiodsp_sdr_rx_tpu.ops import demod as jax_demod
from radiodsp_sdr_rx_tpu.ops import planar as jax_planar
from radiodsp_sdr_rx_tpu_torch.ops import demod, planar
from test_torch_sam import ATOL, FREQ_ATOL, FS, SAME_ATOL, locked_baseband, phase_diff


def _state(c, device="cpu"):
    return planar.sam_init_planar(c, device)


def test_dispatch_runs_the_plain_loop_on_the_cpu():
    rng = np.random.default_rng(3)
    zr, zi = (torch.from_numpy(a) for a in locked_baseband(rng, 2, 333))
    st = _state(2)._replace(phase=torch.tensor([0.5, 6.0]), freq=torch.tensor([1e-3, -2e-3]))
    before = planar.LAUNCHES
    got, gst = planar.demod_sam_planar(zr, zi, st, sample_rate=FS)
    want, wst = planar.demod_sam_planar_plain(zr, zi, st, sample_rate=FS)
    vr = planar.sam_exact(zr, zi, st.phase, st.freq, sample_rate=FS)
    vr_plain = planar.sam_exact_plain(zr, zi, st.phase, st.freq, sample_rate=FS)
    assert planar.LAUNCHES == before
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(gst, wst))
    assert all(torch.equal(a, b) for a, b in zip(vr, vr_plain))
    assert torch.equal(vr[1], gst.phase) and torch.equal(vr[2], gst.freq)


def test_dispatch_raises_on_the_meta_device():
    z = torch.zeros(2, 130, device="meta")
    st = _state(2, "meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        planar.demod_sam_planar(z, z, st)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        planar.sam_exact(z, z, st.phase, st.freq)


def _bad(case):
    c, n = 3, 200
    zr, zi, st = torch.zeros(c, n), torch.zeros(c, n), _state(c)
    if case == "1-d":
        zr = zi = torch.zeros(n)
    elif case == "empty":
        zr = zi = torch.zeros(c, 0)
    elif case == "zi shape":
        zi = torch.zeros(c, n + 1)
    elif case == "float64":
        zr = zr.double()
    elif case == "phase shape":
        st = st._replace(phase=torch.zeros(c + 1))
    elif case == "freq dtype":
        st = st._replace(freq=torch.zeros(c, dtype=torch.float64))
    elif case == "dc shape":
        st = st._replace(dc=torch.zeros(c))
    elif case == "carry device":
        st = st._replace(phase=torch.zeros(c, device="meta"))
    return zr, zi, st


@pytest.mark.parametrize("case", ["1-d", "empty", "zi shape", "float64", "phase shape",
                                  "freq dtype", "dc shape", "carry device"])
def test_argument_checks_raise(case):
    zr, zi, st = _bad(case)
    with pytest.raises(ValueError):
        planar.demod_sam_planar(zr, zi, st)
    with pytest.raises(ValueError):
        planar.demod_sam_planar_plain(zr, zi, st)
    if case != "dc shape":
        with pytest.raises(ValueError):
            planar.sam_exact(zr, zi, st.phase, st.freq)


def _jax_rows(zr, zi, jst):
    """The JAX demod_sam_planar over the rows (vmapped), on a stacked state."""
    demod_rows = jax.vmap(lambda a, b, s: jax_planar.demod_sam_planar(a, b, s, sample_rate=FS))
    return demod_rows(jnp.asarray(zr), jnp.asarray(zi), jst)


@pytest.mark.parametrize("c, n", [(1, 1000), (1, 333), (3, 700)])
def test_demod_sam_planar_threaded_halves_match_jax(c, n):
    rng = np.random.default_rng(c * 1000 + n)
    zr, zi = locked_baseband(rng, c, 2 * n)
    st = _state(c)
    jst = jax_planar.SAMStatePlanar(np.zeros(c, np.float32), np.zeros(c, np.float32),
                                    np.zeros((c, 2), np.float32))
    for seg in range(2):
        sl = slice(seg * n, (seg + 1) * n)
        want, jst = _jax_rows(zr[:, sl], zi[:, sl], jst)
        got, st = planar.demod_sam_planar(torch.from_numpy(zr[:, sl].copy()),
                                          torch.from_numpy(zi[:, sl].copy()), st,
                                          sample_rate=FS)
        assert got.shape == (c, n)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        assert phase_diff(st.phase, jst.phase) <= ATOL
        np.testing.assert_allclose(st.freq.numpy(), np.asarray(jst.freq), atol=FREQ_ATOL, rtol=0)
        np.testing.assert_allclose(st.dc.numpy(), np.asarray(jst.dc), atol=ATOL, rtol=0)


def test_demod_sam_scalar_carries_match_jax():
    rng = np.random.default_rng(8)
    n = 900
    zr, zi = locked_baseband(rng, 1, 2 * n)
    z = (zr[0] + 1j * zi[0]).astype(np.complex64)
    st, jst = demod.sam_init(), jax_demod.sam_init()
    for seg in range(2):
        sl = slice(seg * n, (seg + 1) * n)
        want, jst = jax_demod.demod_sam(jnp.asarray(z[sl]), jst, sample_rate=FS)
        got, st = demod.demod_sam(torch.from_numpy(z[sl]), st, sample_rate=FS)
        assert got.shape == (n,) and st.phase.shape == () and st.freq.shape == ()
        assert st.dc.shape == (2,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        assert phase_diff(st.phase, jst.phase) <= ATOL
        np.testing.assert_allclose(float(st.freq), float(jst.freq), atol=FREQ_ATOL, rtol=0)
        np.testing.assert_allclose(st.dc.numpy(), np.asarray(jst.dc), atol=ATOL, rtol=0)


def test_demod_sam_rows_are_the_scalar_streams():
    """(C, n) streams with (C,) carries: each row is its own (n,) stream with
    () carries."""
    rng = np.random.default_rng(9)
    zr, zi = locked_baseband(rng, 3, 400)
    z = torch.from_numpy((zr + 1j * zi).astype(np.complex64))
    st = demod.SAMState(torch.tensor([0.1, 2.0, 5.0]), torch.tensor([0.0, 1e-3, -1e-3]),
                        torch.zeros(3, 2))
    got, gst = demod.demod_sam(z, st, sample_rate=FS)
    for k in range(3):
        want, wst = demod.demod_sam(z[k], demod.SAMState(st.phase[k], st.freq[k], st.dc[k]),
                                    sample_rate=FS)
        np.testing.assert_allclose(got[k].numpy(), want.numpy(), atol=SAME_ATOL, rtol=0)
        for a, b in zip(gst, wst):
            np.testing.assert_allclose(a[k].numpy(), b.numpy(), atol=SAME_ATOL, rtol=0)
