"""The port's grouped LMS algebra on the CPU, against the JAX package.

``ops/lms_bank.lms_nr_run_bank_plain`` runs the grouped exact algebra of
``csrc/lms_step.cuh`` (groups of LMS_GROUP samples, one unit-lower-triangular
system per group, the lag products telescoped and summed afresh every
LMS_REBASE samples). It is held here:

  - to the JAX ``ops/lms.lms_nr_run`` (the per-sample scan) vmapped over
    channels, and to the JAX grouped TPU kernel ``_lms_grouped_kernel`` in
    interpret mode (``lms_nr_run_pallas(..., group=LMS_GROUP)``, which takes
    128 channels and n a multiple of the group), denoise and notch, the state
    fresh with ``first`` True or False, over two threaded segments, at 2e-4,
    the JAX twin bound (tests/test_pallas_lms.py:35): all are f32 and sum in
    other orders, which the adaptation carries forward. The window and the
    delay line are copies of the input and are compared bit for bit;
  - in float64 to the per-sample recurrence at 1e-9, which shows that the
    algebra is exact whatever the rounding (measured: about 2e-16);
  - its group and rebase period to the kernel's constants.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu.ops import lms as jax_lms
from radiodsp_sdr_rx_tpu.ops.pallas_lms import lms_nr_run_pallas
from radiodsp_sdr_rx_tpu_torch.ops import lms, lms_bank
from radiodsp_sdr_rx_tpu_torch.ops.lms import _EPS
from radiodsp_sdr_rx_tpu_torch.utils import build

ATOL = 2e-4
LANES = 128   # the JAX grouped kernel's channel count (pallas_lms.LANES)


def _scene(seed, c, n):
    """A tone per channel (predictable across the 128-sample delay) in noise,
    two segments' worth."""
    rng = np.random.default_rng(seed)
    t = np.arange(2 * n)
    f = rng.uniform(0.01, 0.2, (c, 1))
    x = 0.3 * np.sin(2 * np.pi * f * t) + 0.1 * rng.standard_normal((c, 2 * n))
    return x.astype(np.float32)


def _state(c, first):
    return lms.lms_nr_init(c)._replace(first=torch.full((c,), first, dtype=torch.bool))


def _assert_close(got, want, atol=ATOL):
    out, w, win, delay = (g.numpy() for g in got)
    np.testing.assert_allclose(out, np.asarray(want[0]), atol=atol, rtol=0)
    np.testing.assert_allclose(w, np.asarray(want[1]), atol=atol, rtol=0)
    np.testing.assert_array_equal(win, np.asarray(want[2]))
    np.testing.assert_array_equal(delay, np.asarray(want[3]))


@pytest.mark.parametrize("n", [1000, 2048])   # n % LMS_GROUP == 8 (a short last group), 0
@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("mode", ["denoise", "notch"])
def test_grouped_plain_matches_jax_scan_over_two_segments(mode, first, n):
    c = 6
    x = _scene(n + len(mode) + first, c, n)
    mu = lms.lms_mu_from_strength(30)
    jst = jax_lms.lms_nr_init()
    jst = jax.tree.map(lambda leaf: jnp.broadcast_to(jnp.asarray(leaf), (c,) + np.shape(leaf)),
                       jst._replace(first=np.bool_(first)))
    st = _state(c, first)
    for seg in range(2):
        xs = x[:, seg * n:(seg + 1) * n]
        want, jst = jax.vmap(lambda a, s: jax_lms.lms_nr_run(a, s, mu, mode=mode))(
            jnp.asarray(xs), jst)
        got = lms_bank.lms_nr_run_bank_plain(torch.as_tensor(xs), st.weights, st.window,
                                             st.delay, st.first, mu, mode)
        _assert_close(got, (want, jst.weights, jst.window, jst.delay))
        st = lms.LMSState(*got[1:], first=torch.zeros(c, dtype=torch.bool))


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("mode", ["denoise", "notch"])
def test_grouped_plain_matches_the_jax_grouped_kernel(mode, first):
    n = 256
    x = _scene(len(mode) + first, LANES, n)
    mu = lms.lms_mu_from_strength(20)
    w, win, delay = (jnp.zeros((LANES, k), jnp.float32) for k in (96, 96, 128))
    st = _state(LANES, first)
    for seg in range(2):
        xs = x[:, seg * n:(seg + 1) * n]
        want = lms_nr_run_pallas(jnp.asarray(xs), w, win, delay, jnp.asarray(first and seg == 0),
                                 mu, mode=mode, group=lms_bank.LMS_GROUP, interpret=True)
        got = lms_bank.lms_nr_run_bank_plain(torch.as_tensor(xs), st.weights, st.window,
                                             st.delay, st.first, mu, mode)
        _assert_close(got, want)
        _, w, win, delay = want
        st = lms.LMSState(*got[1:], first=torch.zeros(LANES, dtype=torch.bool))


def _recurrence(x, w, win, delay, first, mu, mode):
    """The per-sample recurrence of ops/lms.py, in x's dtype."""
    n = x.shape[1]
    xp = torch.cat([win, x], dim=1)
    shifted = torch.cat([delay, x], dim=1)[:, :n]
    d = torch.where(first & (torch.arange(n) < lms.LMS_DELAY), x, shifted)
    w = w.clone()
    out = torch.empty_like(x)
    for t in range(n):
        wt = xp[:, t + 1:t + 1 + lms.LMS_TAPS]
        y = (w * wt).sum(-1)
        e = d[:, t] - y
        w = w + ((mu * e) / ((wt * wt).sum(-1) + _EPS))[:, None] * wt
        out[:, t] = y if mode == "denoise" else e
    return out, w


@pytest.mark.parametrize("n", [77, 1000])
@pytest.mark.parametrize("mode", ["denoise", "notch"])
def test_grouped_algebra_is_exact_in_float64(mode, n):
    """Random weights, window and delay line, first=False: every output, the
    weights after, at 1e-9 of the per-sample recurrence."""
    rng = np.random.default_rng(n)
    c = 4
    x = torch.as_tensor(_scene(n, c, n)[:, :n], dtype=torch.float64)
    w0, win0 = (torch.as_tensor(rng.standard_normal((c, 96)) * s) for s in (0.01, 0.1))
    delay = torch.as_tensor(rng.standard_normal((c, 128)) * 0.1)
    mu = float(np.float32(lms.lms_mu_from_strength(20)))
    want, w_want = _recurrence(x, w0, win0, delay, torch.tensor(False), mu, mode)
    got, w_got, win_got, _ = lms_bank.lms_grouped(x, w0, win0, delay, False, mu, mode)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-9, rtol=0)
    np.testing.assert_allclose(w_got.numpy(), w_want.numpy(), atol=1e-9, rtol=0)
    assert torch.equal(win_got, torch.cat([win0, x], dim=1)[:, n:])


def test_group_and_rebase_match_the_kernel():
    text = (build.CSRC / "lms_step.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert int(consts["kGroup"]) == lms_bank.LMS_GROUP
    assert int(consts["kRebase"]) == lms_bank.LMS_REBASE
    assert lms_bank.LMS_REBASE % lms_bank.LMS_GROUP == 0
