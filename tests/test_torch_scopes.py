"""The port's scopes against the JAX package on the CPU: the analyzer
window, the panadapter's biquad (a log-depth scan in the port, a per-sample
``lax.scan`` in JAX), the audio scope, the S-meter, the display quantities
and renderers, and ``models/metrics.analyze`` over threaded blocks, with a
JAX ``ScopeState`` carried into the port. Same numpy inputs, from a seed.

Tolerances: the window and the renderers' text are equal; the float
outputs are held to the JAX ones within TOL_REL of the output's peak (the
biquad's doubling sums in another order than the sequential scan, and the
FFTs are two libraries'; measured about 4e-7 of the peak); the colour
classes and S-units are thresholds of those and are held equal where the
JAX value is not within the tolerance of a threshold. The biquad alone, on
a random carry and a DC step, is held within TOL_BIQUAD of its peak: the
JAX scan's own f32 rounding there is about 1.4e-5 of the peak from the
float64 recurrence, and both are held within it of the recurrence. The
biquads' carries, a high-passed level far under the signal's, are held
within TOL_BIQUAD of the input's peak.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from radiodsp_sdr_rx_tpu.models import metrics as jmetrics
from radiodsp_sdr_rx_tpu.ops import analyzers as janalyzers
from radiodsp_sdr_rx_tpu.ops import iir as jiir
from radiodsp_sdr_rx_tpu.ops import windows as jwindows
from radiodsp_sdr_rx_tpu.utils import display as jdisplay
from radiodsp_sdr_rx_tpu.utils import smeter as jsmeter
from radiodsp_sdr_rx_tpu_torch.models import metrics
from radiodsp_sdr_rx_tpu_torch.ops import analyzers, iir, windows
from radiodsp_sdr_rx_tpu_torch.utils import convert, display, smeter

FS = 44117.64706
TOL_REL = 5e-6     # of the output's peak
TOL_BIQUAD = 2e-5  # of the output's peak, the biquad on a random carry
BLOCK = 16384      # the CLI's block
APPLIANCE_BLOCK = 4096


def _close(got, want, tol_rel=TOL_REL, scale=None):
    """got within tol_rel of ``scale`` (default: want's peak) of want."""
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    if want.size:
        scale = float(np.abs(want).max()) if scale is None else scale
        np.testing.assert_allclose(got, want, rtol=0, atol=tol_rel * max(scale, 1e-30))


def _scene(n, start, rng):
    """A carrier, noise and a DC offset on IQ; a tone and noise as audio."""
    t = np.arange(start, start + n)
    iq = (0.05 * np.exp(2j * np.pi * 0.1 * t) + 0.002 * (1 + 1j)
          + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    audio = (0.3 * np.sin(2 * np.pi * 0.02 * t) + 0.01 * rng.standard_normal(n)).astype(np.float32)
    return iq, audio


def test_blackman_nuttall_periodic_equals_jax():
    for n in (256, 1024, 7):
        np.testing.assert_array_equal(windows.blackman_nuttall_periodic(n),
                                      jwindows.blackman_nuttall_periodic(n))


def test_biquad_coefficients_equal_jax():
    for f0, q in ((500.0, 0.5), (1200.0, 0.707)):
        assert iir.biquad_highpass(f0, FS, q) == tuple(jiir.biquad_highpass(f0, FS, q))


@pytest.mark.parametrize("shape", [(BLOCK,), (3, 1000)])
def test_biquad_scan_over_two_threaded_calls_matches_jax(shape):
    """Two threaded calls, a DC offset and a random carry: held to the JAX
    sequential scan, and no farther from the float64 recurrence than it."""
    rng = np.random.default_rng(7)
    c = iir.biquad_highpass(500.0, FS, 0.5)
    x = (rng.standard_normal((2,) + shape) * 0.3 + 0.5).astype(np.float32)
    s0 = rng.standard_normal(shape[:-1] + (2,)).astype(np.float32)
    sj, st = jnp.asarray(s0), torch.from_numpy(s0)
    s64 = s0.astype(np.float64)
    for k in range(2):
        yj, sj = jiir.biquad_apply(jnp.asarray(x[k]), c, sj)
        yt, st = iir.biquad_apply(torch.from_numpy(x[k]), c, st)
        _close(yt, yj, TOL_BIQUAD)
        _close(st, sj, TOL_BIQUAD)
        y64 = np.empty(shape)
        for n in range(shape[-1]):
            xn = x[k][..., n].astype(np.float64)
            y64[..., n] = c.b0 * xn + s64[..., 0]
            s64 = np.stack([c.b1 * xn - c.a1 * y64[..., n] + s64[..., 1],
                            c.b2 * xn - c.a2 * y64[..., n]], axis=-1)
        for y in (yt.numpy(), np.asarray(yj)):
            assert np.abs(y - y64).max() <= TOL_BIQUAD * np.abs(y64).max()


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def test_biquad_operations_grow_with_log2_of_the_block():
    """The scan's operations (each a kernel launch on a card) grow by a
    fixed count a doubling of the block, never with the samples: a 16,384-
    sample block takes 4 passes more than a 1,024-sample one."""
    c = iir.biquad_highpass(500.0, FS, 0.5)
    counts = {}
    for n in (1024, 2048, 16384):
        with _CountOps() as mode:
            iir.biquad_apply(torch.ones(n), c, torch.zeros(2))
        counts[n] = mode.ops
    per_pass = counts[2048] - counts[1024]
    assert 0 < per_pass <= 12
    assert counts[16384] - counts[1024] == 4 * per_pass
    assert counts[16384] < 200


def test_audio_spectrum_frames_and_read_match_jax():
    rng = np.random.default_rng(3)
    for naverage, tail in ((8, True), (30, False), (1, True)):
        _, audio = _scene(512 * 31, 0, rng)   # without the tail: 30 frames
        t = rng.standard_normal(512).astype(np.float32) if tail else None
        want = janalyzers.audio_spectrum_frames(jnp.asarray(audio), naverage=naverage,
                                                tail=None if t is None else jnp.asarray(t))
        got = analyzers.audio_spectrum_frames(torch.from_numpy(audio), naverage=naverage,
                                              tail=None if t is None else torch.from_numpy(t))
        _close(got, want)
        _close(analyzers.spectrum_read(got), janalyzers.spectrum_read(want))


def test_iq_spectrum_frames_match_jax_with_the_cached_window():
    rng = np.random.default_rng(4)
    iq, _ = _scene(128 * 60, 0, rng)
    tail = (rng.standard_normal(128) + 1j * rng.standard_normal(128)).astype(np.complex64)
    for _ in range(2):   # the second call reads the window and bin order kept on the device
        got = analyzers.iq_spectrum_frames(torch.from_numpy(iq), naverage=30,
                                           tail=torch.from_numpy(tail))
        _close(got, janalyzers.iq_spectrum_frames(jnp.asarray(iq), naverage=30,
                                                  tail=jnp.asarray(tail)))


def test_smeter_matches_jax():
    rng = np.random.default_rng(5)
    spec = np.abs(rng.standard_normal((3, 9, 256)) * 200).astype(np.float32)
    spec[1] *= 1e4    # past S9
    uv0 = rng.uniform(0, 3, 3).astype(np.float32)
    uvj, lastj = jsmeter.smeter_from_spectrum(jnp.asarray(spec), jnp.asarray(uv0))
    uvt, lastt = smeter.smeter_from_spectrum(torch.from_numpy(spec), torch.from_numpy(uv0))
    _close(uvt, uvj)
    _close(lastt, lastj)
    for got, want in zip(smeter.s_units(uvt), jsmeter.s_units(uvj)):
        _close(got, want)
    s, plus = smeter.s_units(torch.tensor([1e-14, 0.5, 1e4]))
    assert s[0] == 0.0 and s[2] == 9.0 and plus[2] > 0 and plus[1] == 0.0


def test_display_functions_match_jax():
    rng = np.random.default_rng(6)
    spec = np.abs(rng.standard_normal((4, 256)) * 300).astype(np.float32)
    view_old = np.abs(rng.standard_normal((4, 256)) * 40).astype(np.float32)
    hist = np.abs(rng.standard_normal((4, display.MAX_WATERFALL, 128)) * 40).astype(np.float32)
    vj, _ = jdisplay.spectrum_smooth(jnp.asarray(spec), jnp.asarray(view_old))
    vt, vt2 = display.spectrum_smooth(torch.from_numpy(spec), torch.from_numpy(view_old))
    _close(vt, vj)
    assert vt2 is vt
    wj = jdisplay.waterfall_update(jnp.asarray(hist), vj)
    wt = display.waterfall_update(torch.from_numpy(hist), torch.from_numpy(np.array(vj)))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    grid = np.arange(0, 90, 0.5, dtype=np.float32).reshape(2, 90)   # every threshold hit
    cls = display.classify_waterfall_colors(torch.from_numpy(grid))
    assert cls.dtype == torch.int32
    np.testing.assert_array_equal(cls.numpy(),
                                  np.asarray(jdisplay.classify_waterfall_colors(jnp.asarray(grid))))
    assert display.WATERFALL_COLORS == jdisplay.WATERFALL_COLORS
    assert display.WATERFALL_THRESHOLDS == jdisplay.WATERFALL_THRESHOLDS


def test_renderers_equal_jax_on_cpu_tensors():
    rng = np.random.default_rng(8)
    view = np.abs(rng.standard_normal(256) * 50).astype(np.float32)
    hist = np.abs(rng.standard_normal((display.MAX_WATERFALL, 128)) * 50).astype(np.float32)
    audio_bins = np.abs(rng.standard_normal(512) * 10).astype(np.float32)
    assert (display.render_waterfall_ascii(torch.from_numpy(hist))
            == jdisplay.render_waterfall_ascii(hist))
    assert (display.render_spectrum_ascii(torch.from_numpy(view))
            == jdisplay.render_spectrum_ascii(view))
    assert (display.render_audio_spectrum_ascii(torch.from_numpy(audio_bins))
            == jdisplay.render_audio_spectrum_ascii(audio_bins))
    assert (display.render_double_spectrum_ascii(torch.from_numpy(view),
                                                 torch.from_numpy(audio_bins))
            == jdisplay.render_double_spectrum_ascii(view, audio_bins))
    assert display.render_spectrum_cursor() == jdisplay.render_spectrum_cursor()


def _near_threshold(value, ths, tol):
    return any(abs(float(value) - th) <= tol for th in ths)


def _check_metrics(mt, mj):
    assert set(mt) == set(mj)
    for k in mj:
        if k == "waterfall_cls":
            continue
        _close(mt[k], mj[k])
    # the colour classes: equal wherever the JAX cell is not within the
    # tolerance of a threshold
    wf = np.asarray(mj["waterfall"])
    tol = TOL_REL * float(np.abs(wf).max())
    near = np.zeros(wf.shape, bool)
    for th in display.WATERFALL_THRESHOLDS:
        near |= np.abs(wf - th) <= tol
    got, want = mt["waterfall_cls"].numpy(), np.asarray(mj["waterfall_cls"])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got[~near], want[~near])


def test_analyze_over_three_threaded_blocks_matches_jax():
    rng = np.random.default_rng(9)
    sj, st = jmetrics.scope_init(), metrics.scope_init("cpu")
    for k in range(3):
        iq, audio = _scene(BLOCK, k * BLOCK, rng)
        mj, sj = jmetrics.analyze_jit(jnp.asarray(iq), jnp.asarray(audio), sj)
        mt, st = metrics.analyze(torch.from_numpy(iq), torch.from_numpy(audio), st)
        _check_metrics(mt, mj)
        assert mt["spectrum"].shape == (BLOCK // 128 // 30, 256)
        assert not _near_threshold(mj["s_units"], (9.0,), 1e-4)
    for name, got, want in zip(metrics.ScopeState._fields, st, sj):
        if name.startswith("biquad"):
            _close(got, want, TOL_BIQUAD, scale=float(np.abs(iq).max()))
        else:
            _close(got, want)


def test_analyze_at_the_appliance_cadence_matches_jax():
    """4,096-sample blocks with audio_naverage = max(1, min(30, block // 512))
    (models/appliance.py:153): one panadapter and one audio row a block."""
    rng = np.random.default_rng(10)
    kw = dict(audio_naverage=max(1, min(30, APPLIANCE_BLOCK // 512)))
    sj, st = jmetrics.scope_init(), metrics.scope_init("cpu")
    for k in range(3):
        iq, audio = _scene(APPLIANCE_BLOCK, k * APPLIANCE_BLOCK, rng)
        mj, sj = jmetrics.analyze_jit(jnp.asarray(iq), jnp.asarray(audio), sj, **kw)
        mt, st = metrics.analyze(torch.from_numpy(iq), torch.from_numpy(audio), st, **kw)
        _check_metrics(mt, mj)
        assert mt["spectrum"].shape == (1, 256) and mt["audio_spectrum"].shape == (1, 512)


def test_jax_scope_state_continues_in_the_port():
    """Two blocks in JAX, its ScopeState carried into the port
    (utils/convert), the third block in both; and back."""
    rng = np.random.default_rng(11)
    blocks = [_scene(BLOCK, k * BLOCK, rng) for k in range(3)]
    sj = jmetrics.scope_init()
    for iq, audio in blocks[:2]:
        _, sj = jmetrics.analyze_jit(jnp.asarray(iq), jnp.asarray(audio), sj)
    st = convert.state_from_numpy(sj._asdict(), "cpu")
    assert isinstance(st, metrics.ScopeState) and st.iq_tail.dtype == torch.complex64
    for name, v in convert.state_to_numpy(st).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(sj, name)))
    iq, audio = blocks[2]
    mj, _ = jmetrics.analyze_jit(jnp.asarray(iq), jnp.asarray(audio), sj)
    mt, _ = metrics.analyze(torch.from_numpy(iq), torch.from_numpy(audio), st)
    _check_metrics(mt, mj)


def test_scope_init_and_analyze_jit_are_the_jax_surface():
    st = metrics.scope_init("cpu")
    for got, want in zip(st, jmetrics.scope_init()):
        assert tuple(got.shape) == np.shape(want)
        assert got.numpy().dtype == np.asarray(want).dtype
    assert metrics.ScopeState._fields == jmetrics.ScopeState._fields
    assert metrics.analyze_jit is metrics.analyze
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            metrics.scope_init()
