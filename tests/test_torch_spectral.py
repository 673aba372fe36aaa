"""The port's spectral subtraction on the CPU vs the JAX package.

The operators and DFT matrices are designed in float64 numpy by the same
code in both packages, so they are compared bit for bit. The planar
stages are held to their JAX functions (``Precision.HIGHEST``) at 1e-5 over
two threaded calls: both are f32, and the products and the floor's scan sum
in another order (the JAX floor is an associative scan, the port's a
doubling scan). Measured: ``planar_dft_split`` 0 (the same products in the
same order), ``spectral_subtract_planar`` 1.8e-7 (split) and 1.2e-7
(direct) with the floor 1.8e-7 relative, ``spectral_subtract_frames`` 8.8e-9.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from radiodsp_sdr_rx_tpu.ops import planar as jax_planar
from radiodsp_sdr_rx_tpu.ops import spectral_sub as jax_spec
from radiodsp_sdr_rx_tpu_torch.ops import planar, spectral_sub

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n", [256, 128])
def test_operators_bit_equal(n):
    for got, want in zip(spectral_sub.spectral_matmul_ops(n), jax_spec.spectral_matmul_ops(n)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for got, want in zip(planar.dft_matrices(n), jax_planar.dft_matrices(n)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for got, want in zip(planar._split_dft_consts(n), jax_planar._split_dft_consts(n)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_constants_equal():
    names = ("VAD_START_BIN", "VAD_END_BIN", "FLOOR_BETA", "UNDER_FLOOR_GAIN",
             "INLINE_START_BIN", "INLINE_END_BIN", "INLINE_MULT", "INLINE_SEED")
    for name in names:
        assert getattr(spectral_sub, name) == getattr(jax_spec, name), name


def test_planar_dft_split_matches_jax():
    rng = np.random.default_rng(1)
    xr, xi = (rng.standard_normal((4, 16, 256)).astype(np.float32) * 0.05 for _ in range(2))
    want = jax_planar.planar_dft_split(jnp.asarray(xr), jnp.asarray(xi), 256)
    got = planar.planar_dft_split(_t(xr), _t(xi), 256)
    direct = (xr.astype(np.float64) + 1j * xi) @ np.exp(
        -2j * np.pi * np.outer(np.arange(256), np.arange(256)) / 256)
    for g, w, d in zip(got, want, (direct.real, direct.imag)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
        np.testing.assert_allclose(g.numpy(), d, atol=ATOL, rtol=0)


@pytest.mark.parametrize("split_dft", [True, False])
def test_spectral_subtract_planar_matches_jax(split_dft):
    """Two threaded calls (the floor and the frame tails carry), SPEC2's
    level, on noise, whose bins fall under the floor (x0.2), and a tone on
    bin 20 (outside the VAD band), which stays above it (x(1 - nf/mag))."""
    rng = np.random.default_rng(2 + split_dft)
    c, n = 4, 2048
    cos, sin = jax_planar.dft_matrices(256)
    nfloor = np.zeros(c, np.float32)
    tails = [np.zeros((c, 128), np.float32)] * 2
    t_state = (torch.zeros(c), torch.zeros(c, 128), torch.zeros(c, 128))
    for seg in range(2):
        l, r = (rng.standard_normal((c, n)).astype(np.float32) * 0.05 for _ in range(2))
        l += np.sin(2 * np.pi * 20 / 256 * (np.arange(n) + seg * n)).astype(np.float32)
        want = jax_planar.spectral_subtract_planar(
            jnp.asarray(l), jnp.asarray(r), np.float32(30.0), jnp.asarray(nfloor),
            jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(tails[0]), jnp.asarray(tails[1]),
            split_dft=split_dft)
        got = planar.spectral_subtract_planar(
            _t(l), _t(r), 30.0, t_state[0], _t(cos), _t(sin), t_state[1], t_state[2],
            split_dft=split_dft)
        for g, w in zip(got, want):
            assert g.shape == tuple(np.shape(w))
        for i in (0, 1, 3, 4):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), atol=ATOL, rtol=0)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)
        nfloor, tails = np.asarray(want[2]), [np.asarray(want[3]), np.asarray(want[4])]
        t_state = got[2:]
    assert float(nfloor.min()) > 0.0
    assert 0.4 < float(got[0].abs().max()) < 0.9    # the tone, scaled by 1 - nf/mag
    assert float(got[1].abs().max()) < 0.05          # R's noise, scaled by 0.2


def test_spectral_subtract_frames_matches_jax():
    rng = np.random.default_rng(4)
    frames = ((rng.standard_normal((3, 12, 256)) + 1j * rng.standard_normal((3, 12, 256)))
              * 0.05).astype(np.complex64)
    nfloor0 = np.float32([0.0, 0.01, 0.2])
    want = jax_spec.spectral_subtract_frames(jnp.asarray(frames), 40.0, jnp.asarray(nfloor0))
    got = spectral_sub.spectral_subtract_frames(torch.from_numpy(frames), 40.0,
                                                torch.from_numpy(nfloor0))
    assert got[0].shape == tuple(want[0].shape) and got[0].dtype == torch.complex64
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5)
