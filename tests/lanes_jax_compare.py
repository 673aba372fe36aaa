"""Shared by tests/test_torch_lanes_*_jax.py: one route of the port's folded
NR bank against the JAX ``FusedNRBank(fold=True)`` on its lanes kernel in
Pallas interpret mode (``kernel_precision=None``: the products and the MXU
tile transposes in full f32), two threaded segments of 8 ch x 2048 (the SAM
routes' two 1024-sample PLL chunks), the state carried across in both
directions with ``utils/convert.py``.

The audio and the inexact carries are held to ``atol``; the DDS words,
``sb_tail`` (a copy of the raw input), ``lms_first``, the blanker's keep
mask and every carry the route does not run (zeros, or passed through) bit
for bit, the PLL phase wrap-aware.
"""

import numpy as np
import torch

from radiodsp_sdr_rx_tpu.models.fused import FusedNRBank as JaxFusedNRBank
from radiodsp_sdr_rx_tpu.models.fused import FusedNRBankState as JaxFusedNRBankState
from radiodsp_sdr_rx_tpu_torch.utils import convert
from test_torch_lanes_bank import N, ROUTES, configs, freqs, port_bank, scene, seg, warm
from test_torch_sam import phase_diff

EXACT = ("nco_phase", "sb_tail", "lms_first", "nb_mask")


def _junk(state, route):
    """Nonzero values in the carries the route does not run (the JAX kernel
    returns zeros for the LMS rows, the PLL and SSB's dc, and passes the
    spectral and blanker carries through), so that the comparison sees what
    each bank does with them."""
    (mode, *_), nr, nb = ROUTES[route]
    off = [] if nr.startswith("SPEC") else ["nfloor", "spec_tail_l", "spec_tail_r"]
    off += ["lms_weights", "lms_window", "lms_delay"] if nr.startswith("SPEC") else []
    off += [] if mode == "SAM" else ["pll"]
    off += [] if mode in ("AM", "SAM") else ["dc"]
    off += [] if nb else ["nb_avg"]
    fields = state._asdict()
    return state._replace(**{k: np.full(np.shape(fields[k]), 0.01, np.float32) for k in off})


def check_state(got, want, atol, route):
    d = convert.state_to_numpy(got)
    assert list(d) == list(JaxFusedNRBankState._fields)
    sam_route = ROUTES[route][0][0] == "SAM"
    for name, w in want._asdict().items():
        w = np.asarray(w)
        assert d[name].shape == w.shape and d[name].dtype == w.dtype, name
        if name == "pll" and sam_route:
            assert phase_diff(d[name][0], w[0]) <= atol
            np.testing.assert_allclose(d[name][1], w[1], atol=atol, rtol=0, err_msg=name)
        elif name in EXACT or not w.any() or np.array_equal(d[name], w):
            np.testing.assert_array_equal(d[name], w, err_msg=name)
        elif name in ("agc_env", "nfloor"):
            np.testing.assert_allclose(d[name], w, rtol=atol, err_msg=name)
        else:
            np.testing.assert_allclose(d[name], w, atol=atol, rtol=0, err_msg=name)


def compare_with_jax_lanes(route, atol, fold_chunk=2048):
    """Segment 0 through both banks from the same (junk-carrying) state;
    segment 1 through the port from the JAX state converted; segment 1
    through JAX from the port's state converted back. ``fold_chunk`` is the
    JAX kernel's time chunk (the JAX bank's default 2048; SAM with NR caps
    it at 1024). Returns the largest audio difference seen."""
    jc, _ = configs(route)
    jax_bank = JaxFusedNRBank(jc, freqs(route), kernel_precision=None, interpret=True,
                              fold_chunk=fold_chunk)
    port = port_bank(route)
    iq = scene(route)
    jst = _junk(warm(route, iq, jax_bank.init_state()), route)
    st = convert.state_from_numpy(jst._asdict(), "cpu")
    worst = 0.0

    def audio(got, want):
        nonlocal worst
        for key in ("audio_l", "audio_r"):
            g, w = got[key].numpy(), np.asarray(want[key])
            assert g.shape == w.shape == (8, N)
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=key)
            worst = max(worst, float(np.abs(g - w).max()))

    want0, jst1 = jax_bank.process(seg(iq, 0), jst)
    got0, st1 = port.process(seg(iq, 0), st)
    audio(got0, want0)
    check_state(st1, jst1, atol, route)
    got1, st2 = port.process(seg(iq, 1), convert.state_from_numpy(jst1._asdict(), "cpu"))
    want1, jst2 = jax_bank.process(seg(iq, 1), JaxFusedNRBankState(**convert.state_to_numpy(st1)))
    audio(got1, want1)
    check_state(st2, jst2, atol, route)
    back = convert.state_from_numpy(JaxFusedNRBankState(**convert.state_to_numpy(st2)), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, st2))
    return worst
