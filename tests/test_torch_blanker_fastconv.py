"""The complex-IQ noise blanker and overlap-save filters of the port
(``ops/noise_blanker.py``, ``ops/fastconv.py``) vs the JAX package on the CPU.

Blanker: the decisive impulse scene (noise clipped to 2.2x its mean
magnitude, impulses of 8(1+1j) far above the threshold, the average
warm-started), so the same samples are blanked in both; kept samples are
copies (bit for bit), the average to 1e-5 relative (one-pole scans summed
in another order). Filters: the framing is a copy (bit for bit); the
collapsed-operator filter and the FFT filter against their JAX twins at
1e-5 (fp32 products and FFTs, another summation order); the FFT filter
against the operator filter at the JAX test's 2e-4
(tests/test_fastconv.py:45), its carry at 1e-6; two threaded halves against
one pass at 1e-5 (tests/test_fastconv.py:64), at fft_length 256 and 512.
"""

import jax
import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu.ops import fastconv as jax_fastconv
from radiodsp_sdr_rx_tpu.ops import fir_design as jax_fir
from radiodsp_sdr_rx_tpu.ops.noise_blanker import noise_blanker as jax_noise_blanker
from radiodsp_sdr_rx_tpu_torch.ops import fastconv, fir_design
from radiodsp_sdr_rx_tpu_torch.ops.noise_blanker import noise_blanker

FS = 44117.64706


def _impulse_scene(c, n, seed=0):
    rng = np.random.default_rng(seed)
    iq = (rng.standard_normal((c, n)) + 1j * rng.standard_normal((c, n))) * 0.05
    mag = np.abs(iq)
    iq = iq * np.minimum(1.0, 2.2 * mag.mean() / np.maximum(mag, 1e-12))
    for pos in (300, 1111, n - 2, n - 1):
        iq[:, pos] = 8.0 * (1 + 1j)
    return iq.astype(np.complex64)


@pytest.mark.parametrize("threshold_db, tau", [(10.0, 512.0), (6.0, 128.0)])
def test_noise_blanker_matches_jax(threshold_db, tau):
    iq = _impulse_scene(3, 4096)
    avg0 = np.full(3, np.abs(iq).mean(), np.float32)
    want, want_avg = jax.jit(jax_noise_blanker, static_argnums=(2, 3))(iq, avg0, threshold_db,
                                                                       tau)
    got, got_avg = noise_blanker(torch.from_numpy(iq), torch.from_numpy(avg0), threshold_db, tau)
    want = np.asarray(want)
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy() == 0, want == 0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() == 0).sum() >= 4 * 3
    np.testing.assert_allclose(got_avg.numpy(), np.asarray(want_avg), rtol=1e-5)


def _stream(c, n, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((c, n)) + 1j * rng.standard_normal((c, n))) * 0.3).astype(
        np.complex64)


def test_framing_is_a_copy():
    x, tail = _stream(2, 1024, 1), _stream(2, 128, 2)
    want = np.asarray(jax_fastconv.frame_overlap_save(x, tail, 128))
    got = fastconv.frame_overlap_save(torch.from_numpy(x), torch.from_numpy(tail), 128)
    assert np.array_equal(got.numpy(), want) and got.shape == (2, 8, 256)


@pytest.mark.parametrize("fft", [256, 512])
def test_filters_match_jax_and_each_other(fft):
    mask = fir_design.design_filter_mask(300.0, 4000.0, FS, fft)
    assert np.array_equal(mask, jax_fir.design_filter_mask(300.0, 4000.0, FS, fft))
    w = np.ascontiguousarray(fir_design.overlap_save_matrix_real(mask)).astype(np.float32)
    x, tail = _stream(3, 4096, fft), _stream(3, fft // 2, fft + 1)
    t = torch.from_numpy
    y1, t1 = fastconv.overlap_save_filter(t(x), t(w), t(tail))
    y2, t2 = fastconv.overlap_save_filter_fft(t(x), t(mask.astype(np.complex64)), t(tail))
    j1, _ = jax_fastconv.overlap_save_filter(x, w, tail)
    j2, _ = jax_fastconv.overlap_save_filter_fft(x, mask.astype(np.complex64), tail)
    np.testing.assert_allclose(y1.numpy(), np.asarray(j1), atol=1e-5, rtol=0)
    np.testing.assert_allclose(y2.numpy(), np.asarray(j2), atol=1e-5, rtol=0)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=2e-4, rtol=0)
    np.testing.assert_allclose(t1.numpy(), t2.numpy(), atol=1e-6, rtol=0)
    assert np.array_equal(t1.numpy(), x[:, -fft // 2:])
    # streaming: two halves with the carry equal one pass
    a, ta = fastconv.overlap_save_filter(t(x[:, :2048]), t(w), t(tail))
    b, _ = fastconv.overlap_save_filter(t(x[:, 2048:]), t(w), ta)
    np.testing.assert_allclose(torch.cat([a, b], dim=-1).numpy(), y1.numpy(), atol=1e-5)
