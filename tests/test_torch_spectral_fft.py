"""The spectral kernels' 256-point FFT, modelled in PyTorch on the CPU.

The port's spectral kernels (K4 and K6's spectral routes, ``spectral_rows``
in ``csrc/sweep_chain.cuh``) run the stage's DFT as an in-block FFT, radix
8 x 8 x 4, with the bins left in digit-reversed order; the TPU kernels and
the port's plain version multiply by the dense operators
``spectral_matmul_ops(256)``. ``spectral_sub.fft256_model`` is the kernels'
FFT stage for stage and ``spectral_fft_model`` their whole stage. Held here:

- the FFT to ``np.fft`` in float64 (a float64 twiddle table): <= 1e-12 x the
  frame's peak, forward and inverse (rounding alone: about 4e-16 measured);
- the FFT in float32 to the dense float32 products: <= 1e-5 x peak (each
  side rounds in float32, the products over 512 terms; about 1e-6 measured);
- the digit-reversed order: every natural bin at the position the kernels'
  lanes and registers give it, the VAD band and the kept outputs 128..255
  at their indices;
- the stage to the JAX ``spectral_subtract_frames`` and to the port's dense
  plain stage (``ops/sweep.spectral_plain``), frame by frame: a frame with no
  bin within 1e-4 (relative) of the floor to 1e-5, one with k such bins to
  1e-5 + k * 0.2 * nf / 256 (a bin at the floor takes the scale 0.2 or about
  0 as the summation order lands; chip_smoke.py's ``spectral_diff``), the
  floors frame by frame to 1e-5 relative (float32 sums of 151 magnitudes);
- the launcher's check that the operators are the DFT
  (``ops/sweep.check_spectral_ops``), on CPU tensors.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from radiodsp_sdr_rx_tpu.ops import spectral_sub as jax_spec
from radiodsp_sdr_rx_tpu_torch.ops import spectral_sub, sweep

POS = np.arange(256)
FRAME_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _frames(kind, rng, c=3):
    n = np.arange(256)
    if kind == "noise":
        return rng.standard_normal((c, 256)) + 1j * rng.standard_normal((c, 256))
    if kind == "tones":
        k = rng.integers(0, 256, (c, 3))
        return sum(np.exp(2j * np.pi * k[:, i:i + 1] * n / 256) for i in range(3))
    z = np.zeros((c, 256), complex)   # impulses
    z[np.arange(c), rng.integers(0, 256, c)] = 1.0 - 2.0j
    return z


def _natural(dr):
    """A digit-reversed spectrum (..., 256) in natural bin order."""
    out = np.empty_like(dr)
    out[..., spectral_sub.fft_bin_of(POS)] = dr
    return out


@pytest.mark.parametrize("kind", ["noise", "tones", "impulses"])
def test_fft_model_matches_numpy_in_float64(kind):
    z = _frames(kind, np.random.default_rng(len(kind)))
    tw = _t(spectral_sub.fft_twiddles(np.float64))
    sr, si = spectral_sub.fft256_model(_t(z.real), _t(z.imag), tw)
    spec = np.fft.fft(z)
    peak = np.abs(spec).max()
    assert np.abs(_natural((sr + 1j * si).numpy()) - spec).max() <= 1e-12 * peak
    dr = spec[..., spectral_sub.fft_bin_of(POS)]
    yr, yi = spectral_sub.fft256_model(_t(dr.real), _t(dr.imag), tw, inverse=True)
    y = (yr + 1j * yi).numpy() / 256
    assert np.abs(y - np.fft.ifft(spec)).max() <= 1e-12 * np.abs(z).max()


def test_fft_model_matches_dense_operators_in_float32():
    rng = np.random.default_rng(5)
    fl, fr = (rng.standard_normal((16, 256)).astype(np.float32) * 0.1 for _ in range(2))
    w_fwd, w_inv = spectral_sub.spectral_matmul_ops(256)
    tw = _t(spectral_sub.fft_twiddles())
    dense = np.concatenate([fl, fr], -1) @ w_fwd
    sr, si = spectral_sub.fft256_model(_t(fl), _t(fr), tw)
    got = _natural((sr + 1j * si).numpy())
    peak = np.abs(dense).max()
    assert np.abs(got.real - dense[:, :256]).max() <= 1e-5 * peak
    assert np.abs(got.imag - dense[:, 256:]).max() <= 1e-5 * peak
    # the inverse: a spectrum [sr | si] in natural order through W_inv, which
    # keeps the right half and divides by 256
    sp = rng.standard_normal((16, 512)).astype(np.float32)
    dense = sp @ w_inv
    dr = sp[:, :256] + 1j * sp[:, 256:]
    dr = dr[:, spectral_sub.fft_bin_of(POS)]
    yr, yi = spectral_sub.fft256_model(_t(dr.real.astype(np.float32)),
                                       _t(dr.imag.astype(np.float32)), tw, inverse=True)
    peak = np.abs(dense).max()
    assert np.abs(yr[:, 128:].numpy() / 256 - dense[:, :128]).max() <= 1e-5 * peak
    assert np.abs(yi[:, 128:].numpy() / 256 - dense[:, 128:]).max() <= 1e-5 * peak


def test_digit_reversed_order():
    """Each natural bin lands at the position the kernels give it (lane q's
    register j is position 8q + j: k1 = q >> 2, k2a = 2 (q & 3) + (j >> 2),
    k2b = j & 3); the VAD band and the kept outputs sit where the kernels
    read them."""
    tw = _t(spectral_sub.fft_twiddles(np.float64))
    n = np.arange(256)
    tones = np.exp(2j * np.pi * np.arange(256)[:, None] * n / 256)   # row k: bin k
    sr, si = spectral_sub.fft256_model(_t(tones.real), _t(tones.imag), tw)
    where = np.abs((sr + 1j * si).numpy()).argmax(-1)   # the position of bin k
    bins = spectral_sub.fft_bin_of(POS)
    assert np.array_equal(bins[where], np.arange(256))
    assert sorted(bins) == list(range(256))
    lane, reg = POS // 8, POS % 8
    kernel_bin = (lane >> 2) + 8 * (2 * (lane & 3) + (reg >> 2)) + 64 * (reg & 3)
    assert np.array_equal(kernel_bin, bins)
    # the VAD band by position is the natural band, and its sum is the natural sum
    band = (bins >= spectral_sub.VAD_START_BIN) & (bins <= spectral_sub.VAD_END_BIN)
    assert sorted(bins[band]) == list(range(30, 181))
    z = _frames("noise", np.random.default_rng(9))
    sr, si = spectral_sub.fft256_model(_t(z.real), _t(z.imag), tw)
    mag = np.abs((sr + 1j * si).numpy())
    want = np.abs(np.fft.fft(z))[:, 30:181].sum(-1)
    np.testing.assert_allclose(mag[:, band].sum(-1), want, rtol=1e-12)
    assert not np.allclose(mag[:, 30:181].sum(-1), want, rtol=1e-3)   # the trap
    # the kept outputs: a bin's inverse, samples 128..255
    dr = np.zeros((256, 256))
    dr[np.arange(256), where] = 1.0
    yr, yi = spectral_sub.fft256_model(_t(dr), _t(np.zeros_like(dr)), tw, inverse=True)
    y = (yr + 1j * yi).numpy()[:, 128:]
    np.testing.assert_allclose(y, tones[:, 128:], atol=1e-12)


def test_twiddle_table_is_float64_rounded():
    tw = spectral_sub.fft_twiddles()
    assert tw.dtype == np.float32 and tw.shape == (2, 256)
    w = 2 * np.pi * np.arange(256) / 256
    assert np.array_equal(tw, np.stack([np.cos(w), -np.sin(w)]).astype(np.float32))
    # the kernels' constant for W^32 = sqrt(1/2) (1 - i)
    assert tw[0, 32] == np.float32(0.70710678118654752) == -tw[1, 32]


def _frame_diff(got, want, mag, nf):
    """Max |got - want| per 128-sample frame (C, rows), the count of bins
    within 1e-4 of the floor per frame, and whether every frame is within
    FRAME_TOL plus the flips' allowance."""
    c = got[0].shape[0]
    d = np.stack([np.abs(g - w).reshape(c, -1, 128).max(-1) for g, w in zip(got, want)]).max(0)
    near = (np.abs(mag - nf[..., None]) <= 1e-4 * nf[..., None]).sum(-1)
    return d, near, bool((d <= FRAME_TOL + near * 0.2 * nf / 256).all())


def _stage_inputs(level, seed, c=4, rows=40):
    """Post-PBT l, r (C, n): 0.01-sigma noise and two strong tones per
    channel, so that bins lie on both sides of the floor."""
    rng = np.random.default_rng(seed)
    n = rows * 128
    t = np.arange(n)
    f = rng.uniform(0.02, 0.4, (c, 2))
    l = 0.01 * rng.standard_normal((c, n)) + np.cos(2 * np.pi * f[:, :1] * t)
    r = 0.01 * rng.standard_normal((c, n)) + 0.5 * np.sin(2 * np.pi * f[:, 1:] * t)
    tails = 0.01 * rng.standard_normal((2, c, 128))
    nf0 = rng.uniform(0.0, 2.0, c)
    return [a.astype(np.float32) for a in (l, r, tails[0], tails[1], nf0)]


@pytest.mark.parametrize("level", [1.0, 30.0])
def test_stage_model_matches_jax_frame_by_frame(level):
    l, r, tl, tr, nf0 = _stage_inputs(level, int(level))
    c, n = l.shape
    rows = n // 128
    yl, yr, nfloor = spectral_sub.spectral_fft_model(_t(l), _t(r), _t(nf0), _t(tl), _t(tr),
                                                     sweep.nr_gain(level))
    prev_l = np.concatenate([tl[:, None], l.reshape(c, rows, 128)[:, :-1]], 1)
    prev_r = np.concatenate([tr[:, None], r.reshape(c, rows, 128)[:, :-1]], 1)
    frames = (np.concatenate([prev_l, l.reshape(c, rows, 128)], -1)
              + 1j * np.concatenate([prev_r, r.reshape(c, rows, 128)], -1)).astype(np.complex64)
    out, _ = jax_spec.spectral_subtract_frames(jnp.asarray(frames), level, jnp.asarray(nf0))
    out = np.asarray(out).reshape(c, n)
    # the JAX floor frame by frame: one frame a call, the floor carried
    jax_nf, carry = [], jnp.asarray(nf0)
    for k in range(rows):
        carry = jax_spec.spectral_subtract_frames(jnp.asarray(frames[:, k:k + 1]), level, carry)[1]
        jax_nf.append(np.asarray(carry))
    jax_nf = np.stack(jax_nf, -1)
    nf = np.maximum(nfloor.numpy(), 0.0)
    np.testing.assert_allclose(nf, jax_nf, rtol=1e-5, atol=0)
    mag = np.abs(np.fft.fft(frames.astype(np.complex128)))
    d, near, ok = _frame_diff((yl.numpy(), yr.numpy()), (out.real, out.imag), mag, nf)
    assert ok, (d.max(), near.sum())
    assert float((mag > nf[..., None]).mean()) > 0.004   # bins above the floor were scaled


@pytest.mark.parametrize("level", [1.0, 30.0])
def test_stage_model_matches_dense_plain_frame_by_frame(level):
    """The kernels' stage against the port's plain stage, the one the card
    holds the kernels to: the dense fp32 products."""
    l, r, tl, tr, nf0 = (_t(a) for a in _stage_inputs(level, 7 + int(level)))
    yl, yr, nfloor = spectral_sub.spectral_fft_model(l, r, nf0, tl, tr, sweep.nr_gain(level))
    w_fwd, w_inv = (_t(w) for w in spectral_sub.spectral_matmul_ops(256))
    spec = sweep.SpecArgs(w_fwd, w_inv, nf0, tl, tr, level)
    pl, pr, pnf, ptl, ptr = sweep.spectral_plain(l, r, spec)
    _, _, mag, plain_floor = sweep.spectral_floor(l, r, w_fwd, nf0, tl, tr, level)
    np.testing.assert_allclose(nfloor.numpy(), plain_floor.numpy(), rtol=1e-5, atol=0)
    np.testing.assert_allclose(nfloor[:, -1].numpy(), pnf.numpy(), rtol=1e-5, atol=0)
    nf = plain_floor.clamp(min=0.0).numpy()
    d, near, ok = _frame_diff((yl.numpy(), yr.numpy()), (pl.numpy(), pr.numpy()),
                              mag.numpy(), nf)
    assert ok, (d.max(), near.sum())


def test_launcher_admits_only_the_dft_operators():
    w_fwd, w_inv = (_t(w) for w in spectral_sub.spectral_matmul_ops(256))
    sweep.check_spectral_ops(w_fwd, w_inv)
    sweep.check_spectral_ops(w_fwd, w_inv)   # the second time from the cache
    bad = w_fwd.clone()
    bad[3, 4] += 1e-6
    with pytest.raises(ValueError, match="w_spec_fwd"):
        sweep.check_spectral_ops(bad, w_inv)
    with pytest.raises(ValueError, match="w_spec_inv"):
        sweep.check_spectral_ops(w_fwd, w_inv * 2.0)
    with pytest.raises(ValueError, match="w_spec_inv"):
        sweep.check_spectral_ops(w_fwd, w_inv[:, :128])
    # a checked operator changed in place is compared again
    w_fwd[0, 0] = 0.5
    with pytest.raises(ValueError, match="w_spec_fwd"):
        sweep.check_spectral_ops(w_fwd, w_inv)
