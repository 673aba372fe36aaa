"""The port's LMS noise reducer / auto-notch on the CPU vs the JAX package.

``lms_nr_run_bank_plain`` (the per-sample recurrence across a bank) against
the JAX ``ops/lms.lms_nr_run`` vmapped over channels, denoise and notch,
``first`` true into the first segment and false into the second: 2e-4, the
JAX twin bound (tests/test_pallas_lms.py:35): both are f32 and the 96-tap
sums run in another order, which the adaptation carries forward. The delay
line and the window are copies of the input and are compared bit for bit.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from radiodsp_sdr_rx_tpu.ops import lms as jax_lms
from radiodsp_sdr_rx_tpu_torch.ops import lms, lms_bank

ATOL = 2e-4
C, N = 6, 1024


def _scene(rng, c, n):
    """A tone per channel (predictable across the 128-sample delay) in noise."""
    t = np.arange(2 * n)
    f = rng.uniform(0.01, 0.2, (c, 1))
    x = 0.3 * np.sin(2 * np.pi * f * t) + 0.1 * rng.standard_normal((c, 2 * n))
    return x.astype(np.float32)


def _jax_run(x, st, mu, mode):
    return jax.vmap(lambda a, s: jax_lms.lms_nr_run(a, s, mu, mode=mode))(jnp.asarray(x), st)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("mode", ["denoise", "notch"])
@pytest.mark.parametrize("strength", [20, 30])
def test_plain_matches_vmapped_jax_over_two_segments(mode, strength):
    rng = np.random.default_rng(strength + len(mode))
    x = _scene(rng, C, N)
    mu = lms.lms_mu_from_strength(strength)
    jst = jax.tree.map(lambda leaf: jnp.broadcast_to(jnp.asarray(leaf), (C,) + np.shape(leaf)),
                       jax_lms.lms_nr_init())
    st = lms.lms_nr_init(C)
    for seg in range(2):
        xs = x[:, seg * N:(seg + 1) * N]
        want, jst = _jax_run(xs, jst, mu, mode)
        got, st = lms.lms_nr_run(_t(xs), st, mu, mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        np.testing.assert_allclose(st.weights.numpy(), np.asarray(jst.weights), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(st.window.numpy(), np.asarray(jst.window))
        np.testing.assert_array_equal(st.delay.numpy(), np.asarray(jst.delay))
        assert not st.first.any()
    # the quirk mattered: a notch from a fresh state differs where first=False
    if mode == "notch":
        fresh, _ = lms.lms_nr_run(_t(x[:, :N]), lms.lms_nr_init(C)._replace(
            first=torch.zeros(C, dtype=torch.bool)), mu, mode)
        quirk, _ = lms.lms_nr_run(_t(x[:, :N]), lms.lms_nr_init(C), mu, mode)
        assert not torch.equal(fresh[:, :128], quirk[:, :128])


def test_mu_law_matches_jax():
    for s in (0, 20, 30, 40, 50, 37.5):
        assert lms.lms_mu_from_strength(s) == jax_lms.lms_mu_from_strength(s)


def test_short_segments_carry_the_delay_line():
    """Segments shorter than the delay line (n < 128) keep its older part:
    after eight 64-sample segments the delay line and the window are those of
    one 512-sample run, bit for bit."""
    rng = np.random.default_rng(3)
    x = _t(_scene(rng, 3, 256)[:, :512])
    mu = lms.lms_mu_from_strength(30)
    whole, st_whole = lms.lms_nr_run(x, lms.lms_nr_init(3), mu)
    st = lms.lms_nr_init(3)
    parts = []
    for k in range(8):
        out, st = lms.lms_nr_run(x[:, 64 * k:64 * (k + 1)].contiguous(), st, mu)
        parts.append(out)
    # the quirk covers the first segment only (64 samples) where the whole
    # run has it for 128, so the outputs agree over the first segment
    np.testing.assert_array_equal(st.delay.numpy(), st_whole.delay.numpy())
    np.testing.assert_array_equal(st.window.numpy(), st_whole.window.numpy())
    got = torch.cat(parts, dim=1)
    np.testing.assert_allclose(got[:, :64].numpy(), whole[:, :64].numpy(), atol=1e-6, rtol=0)


def test_split_segments_equal_one_segment():
    rng = np.random.default_rng(4)
    x = _t(_scene(rng, 4, 1024))
    mu = lms.lms_mu_from_strength(40)
    whole, st_w = lms.lms_nr_run(x, lms.lms_nr_init(4), mu, "notch")
    a, st = lms.lms_nr_run(x[:, :768].contiguous(), lms.lms_nr_init(4), mu, "notch")
    b, st = lms.lms_nr_run(x[:, 768:].contiguous(), st, mu, "notch")
    np.testing.assert_allclose(torch.cat([a, b], 1).numpy(), whole.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(st.weights.numpy(), st_w.weights.numpy(), atol=1e-6, rtol=0)


def _args(c=2, n=256):
    z = torch.zeros
    return [z(c, n), z(c, 96), z(c, 96), z(c, 128), True, 0.01, "denoise"]


@pytest.mark.parametrize("index, bad", [
    (0, torch.zeros(2, 0)),                     # empty segment
    (1, torch.zeros(2, 64)),                    # weights are (C, 96)
    (2, torch.zeros(3, 96)),                    # window: another channel count
    (3, torch.zeros(2, 96)),                    # delay is (C, 128)
    (1, torch.zeros(2, 96, dtype=torch.float64)),   # f32 only
    (6, "spectral"),                            # mode
])
def test_rejects_bad_arguments(index, bad):
    args = _args()
    args[index] = bad
    with pytest.raises(ValueError):
        lms_bank.lms_nr_run_bank(*args)


def test_rejects_other_devices():
    args = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in _args()]
    with pytest.raises(ValueError):
        lms_bank.lms_nr_run_bank(*args)


def test_cpu_tensors_never_launch():
    before = lms_bank.LAUNCHES
    out, w, win, d = lms_bank.lms_nr_run_bank(*_args())
    assert out.shape == (2, 256) and w.shape == win.shape == (2, 96) and d.shape == (2, 128)
    assert lms_bank.LAUNCHES == before
