"""The port's ``agc_run`` (the staged backend's AGC) vs the JAX ``agc_run``.

Same log-domain form in both (cumulative max of log|x| offset by k*d, in
16384-sample chunks with the envelope carried): the only differences are
ulps of log/exp between XLA and PyTorch on the CPU. Tolerance: rtol 1e-5 on
the envelope carry and on y, with atol 1e-6 for y near zero; the measured
max is 1.2e-7 relative on the envelope and 1.5e-7 absolute on y.
"""

import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu.ops import agc as jagc
from radiodsp_sdr_rx_tpu_torch.ops import agc as tagc

FS = 44117.64706


@pytest.mark.parametrize("n", [8192, 40960])   # one chunk; three, the last padded
@pytest.mark.parametrize("preset", ["medium", "off"])
@pytest.mark.parametrize("env0", [1e-6, "carried"])
def test_agc_run_matches_jax(n, preset, env0):
    jp = jagc.agc_presets(FS)[preset]
    tp = tagc.agc_presets(FS)[preset]
    assert tuple(jp) == tuple(tp)
    rng = np.random.default_rng(n + len(preset))
    c = 4
    x = (rng.standard_normal((c, n)) * 0.05).astype(np.float32)
    x[:, n // 3:n // 3 + 500] *= 40.0          # attack, then a long release
    e0 = (np.full(c, 1e-6, np.float32) if env0 == 1e-6
          else rng.uniform(0.5, 3.0, c).astype(np.float32))   # a loud past
    # the JAX bank hands agc_run f32 constants (models/fused.py:92-95)
    jp = jp._replace(release=np.float32(jp.release), target=np.float32(jp.target),
                     max_gain=np.float32(jp.max_gain))
    tp = tp._replace(release=float(np.float32(tp.release)),
                     target=float(np.float32(tp.target)),
                     max_gain=float(np.float32(tp.max_gain)))
    want_y, want_e = jagc.agc_run(x, jp, e0)
    got_y, got_e = tagc.agc_run(torch.from_numpy(x), tp, torch.from_numpy(e0))
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), rtol=1e-5, atol=0)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-6)
    assert got_y.shape == (c, n) and got_e.shape == (c,)


def test_agc_envelope_is_the_recurrence():
    """env[k] = max(|x[k]|, env[k-1]*release), checked against a loop."""
    rng = np.random.default_rng(0)
    mag = np.abs(rng.standard_normal((2, 20000))).astype(np.float32)
    release = 0.999
    env, last = tagc.agc_envelope(torch.from_numpy(mag), torch.tensor([0.5, 4.0]), release)
    want = np.empty_like(mag)
    e = np.array([0.5, 4.0])
    for k in range(mag.shape[1]):
        e = np.maximum(mag[:, k], e * release)
        want[:, k] = e
    np.testing.assert_allclose(env.numpy(), want, rtol=2e-5)
    np.testing.assert_allclose(last.numpy(), want[:, -1], rtol=2e-5)
