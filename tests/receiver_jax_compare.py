"""Shared by the tests that hold the port's single-channel ``Receiver`` (and
``ReceiverBank``) to the JAX package's on the CPU.

``configs`` builds the same configuration in both packages; ``scene`` the
complex64 input numpy makes from a seed; ``run_jax`` / ``run_port`` thread a
receiver over equal segments; ``assert_states_close`` holds every leaf of a
port state to the JAX state: the DDS word and the LMS ``first`` flag bit for
bit; the carried blocks of the mixed stream (``sb_tail``, ``conv_tail``) to
1e-6, a few f32 ulps of the input (not bit for bit: XLA and PyTorch round the
mix's sin and cos apart), which tells the mixed block from the raw one by
orders of magnitude; the SAM phase wrap-aware; the one-pole carries
relative; every other leaf to the chain's bound.
"""

import numpy as np

from radiodsp_sdr_rx_tpu.models import config as jcfg
from radiodsp_sdr_rx_tpu.models.receiver import Receiver as JaxReceiver
from radiodsp_sdr_rx_tpu_torch.models import config as tcfg
from radiodsp_sdr_rx_tpu_torch.models.receiver import Receiver
from radiodsp_sdr_rx_tpu_torch.utils import convert

FS = 44117.64706
ATOL = 1e-4       # both f32; products, scans and sums in another order
LMS_ATOL = 2e-4   # the LMS twin bound (tests/test_pallas_lms.py:35)
TAIL_ATOL = 1e-6  # the carried mixed blocks
_TAILS = ("sb_tail_r", "sb_tail_i", "conv_tail_r", "conv_tail_i")
CENTER = 7_050_000.0
OFFSET = 2_000.0  # the station sits this far above the capture centre
_VFO = {"CW_NARROW": 14_050_000.0, "CW": 14_050_000.0}


def configs(mode, nr="OFF", agc="MEDIUM", **kw):
    """(JAX config, port config) of one receiver: the station OFFSET Hz
    above the capture centre (CW on 20 m, where the side tone is +700 Hz)."""
    vfo = _VFO.get(mode, CENTER + OFFSET)
    common = dict(vfo_freq=vfo, capture_center_freq=vfo - OFFSET, **kw)
    return (jcfg.ReceiverConfig(mode=jcfg.DemodMode[mode], nr=jcfg.NRMode[nr],
                                agc=jcfg.AGCMode[agc], **common),
            tcfg.ReceiverConfig(mode=tcfg.DemodMode[mode], nr=tcfg.NRMode[nr],
                                agc=tcfg.AGCMode[agc], **common))


def scene(mode, n, seed, impulses=False):
    """Complex64 (n,): for AM and SAM a carrier locked on the tuned
    frequency (within 20 Hz; the SAM PLL is chaotic on noise) with a 450 Hz
    tone at depth 0.4; else a voice-band tone pair above the tuned
    frequency; 0.05-sigma noise and a 4x burst. With ``impulses``: noise
    clipped to 2.2x its mean magnitude and impulses of 8(1+1j), far above
    the blanker's threshold (the decisive scene of tests/test_fused_bank.py:
    484-545)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    noise = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.05
    if impulses:
        mag = np.abs(noise)
        iq = noise * np.minimum(1.0, 2.2 * mag.mean() / np.maximum(mag, 1e-12))
        for pos in (500, 1733, n // 2 - 3, n // 2 - 1, n - 901):
            iq[pos] = 8.0 * (1 + 1j)
        return iq.astype(np.complex64)
    if mode in ("AM", "SAM"):
        sig = (1.0 + 0.4 * np.sin(2 * np.pi * 450.0 * t)) * np.exp(
            1j * (2 * np.pi * (OFFSET + 17.0) * t + 0.3))
        sig = 0.3 * sig
    else:
        tuned = 700.0 if mode in _VFO else 0.0
        sig = 0.2 * (np.exp(2j * np.pi * (OFFSET + tuned + 900.0) * t)
                     + 0.5 * np.exp(2j * np.pi * (OFFSET + tuned + 1_700.0) * t + 1.0))
        sig = sig if mode != "LSB" else np.conj(sig) * np.exp(4j * np.pi * OFFSET * t)
    iq = sig + noise
    iq[n // 3:n // 3 + 300] *= 4.0
    return iq.astype(np.complex64)


def run_jax(cfg, iq, segments, state=None, rx=None):
    """Thread the JAX Receiver over ``segments`` equal parts of iq. Returns
    (outputs as numpy dicts, states after each segment, the receiver)."""
    rx = rx or JaxReceiver(cfg)
    st = rx.init_state() if state is None else state
    n = len(iq) // segments
    outs, states = [], []
    for s in range(segments):
        out, st = rx.process(iq[s * n:(s + 1) * n], st)
        outs.append({k: np.asarray(v) for k, v in out.items()})
        states.append(st)
    return outs, states, rx


def run_port(cfg, iq, segments, state=None, rx=None):
    """The same for the port's Receiver on the CPU."""
    rx = rx or Receiver(cfg, device="cpu")
    st = rx.init_state() if state is None else state
    n = len(iq) // segments
    outs, states = [], []
    for s in range(segments):
        out, st = rx.process(iq[s * n:(s + 1) * n], st)
        outs.append({k: v.numpy() for k, v in out.items()})
        states.append(st)
    return outs, states, rx


def phase_diff(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) % (2 * np.pi)
    return float(np.minimum(d, 2 * np.pi - d).max())


def assert_outputs_close(got, want, atol=ATOL):
    for g, w in zip(got, want):
        for key in ("audio_l", "audio_r"):
            assert g[key].shape == w[key].shape
            np.testing.assert_allclose(g[key], w[key], atol=atol, rtol=0)


def assert_states_close(port_state, jax_state, lms_atol=LMS_ATOL):
    """Every leaf of a port state (as ``convert.state_to_numpy`` gives it)
    against the JAX state, shapes and dtypes included."""
    got = convert.state_to_numpy(port_state)
    want = jax_state._asdict()
    assert set(got) == set(want)
    for name, w in want.items():
        if name in ("lms", "sam"):
            for field, leaf in w._asdict().items():
                g, leaf = got[name][field], np.asarray(leaf)
                assert g.shape == leaf.shape and g.dtype == leaf.dtype, (name, field)
                if field == "first":
                    np.testing.assert_array_equal(g, leaf)
                elif field == "phase":
                    assert phase_diff(g, leaf) <= ATOL
                else:
                    np.testing.assert_allclose(g, leaf, atol=lms_atol if name == "lms" else ATOL,
                                               rtol=0)
            continue
        g, w = got[name], np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name == "nco_phase":
            np.testing.assert_array_equal(g, w)
        elif name in _TAILS:
            np.testing.assert_allclose(g, w, atol=TAIL_ATOL, rtol=0)
        elif name in ("agc_env", "nb_avg", "nfloor"):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-12)
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
