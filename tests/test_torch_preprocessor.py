"""The port's IQ pre-processor (``ops/preprocessor.py``) and the
``Receiver``'s I2S repair on the CPU vs the JAX package.

The slip detector picks the argmax of three spectral-asymmetry scores, so
the port's index is held equal to JAX's only on decisive scenes: a USB voice
signal (strongly asymmetric) with a known one-sample slip of I or Q. On
symmetric noise the scores nearly tie and two summation orders may pick
apart. The scores themselves agree to 1e-4 relative (both complex64 FFTs,
summed in another order). The repairs are copies and agree bit for bit. The
``Receiver``'s per-segment re-scoring with hysteresis gives the same
sequence of locked repairs in both packages over eight segments, with a slip
that starts in the middle of one.
"""

import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu.ops import preprocessor as jpre
from radiodsp_sdr_rx_tpu_torch.ops import preprocessor
from radiodsp_sdr_rx_tpu_torch.utils import siggen

from receiver_jax_compare import FS, OFFSET, assert_outputs_close, configs, run_jax, run_port

SEG = 4096


def slipped_scene(n, slip_at, which, seed=0, slip_to=None):
    """Complex64 (n,): a USB voice-like signal OFFSET Hz above the centre in
    weak noise, with I ("i") or Q ("q") one sample late from ``slip_at``
    (until ``slip_to``), as a slipped I2S link delivers it."""
    audio = siggen.voice_like(n, FS, seed=seed)
    iq = siggen.ssb_from_audio(audio, OFFSET, FS, "usb", amp=0.4) + siggen.noise(n, 0.01, seed)
    re, im = iq.real.copy(), iq.imag.copy()
    plane = im if which == "q" else re
    end = n if slip_to is None else slip_to
    late = np.concatenate([plane[:1], plane[:-1]])
    plane[slip_at:end] = late[slip_at:end]
    return (re + 1j * im).astype(np.complex64)


@pytest.mark.parametrize("which, want", [(None, 0), ("i", 3), ("q", 2)])
def test_slip_detector_matches_jax(which, want):
    iq = slipped_scene(2 * SEG, 0, which or "q", slip_to=0 if which is None else None)
    xr, xi = iq.real.copy(), iq.imag.copy()
    assert jpre.detect_iq_error_host(xr, xi) == want
    assert preprocessor.detect_iq_error_host(torch.from_numpy(xr), torch.from_numpy(xi)) == want
    # a batch of channels: the mean score over them
    xr3 = np.stack([xr, xr * 0.5, xr * 2.0])
    xi3 = np.stack([xi, xi * 0.5, xi * 2.0])
    assert preprocessor.detect_iq_error_host(xr3, xi3) == jpre.detect_iq_error_host(xr3, xi3)


def test_complex_detector_scores_and_repairs_match_jax():
    iq = slipped_scene(SEG, 0, "i")
    t = torch.from_numpy(iq)
    np.testing.assert_allclose(preprocessor.spectral_asymmetry(preprocessor._candidates(t)).numpy(),
                               np.asarray(jpre.spectral_asymmetry(jpre._candidates(iq))),
                               rtol=1e-4)
    idx = preprocessor.detect_iq_error(t)
    assert int(idx) == int(jpre.detect_iq_error(iq)) == 3
    for k in range(4):
        assert np.array_equal(preprocessor.repair_iq(t, k).numpy(),
                              np.asarray(jpre.repair_iq(iq, k)))
    np.testing.assert_allclose(preprocessor.iq_gain_balance(t).numpy(),
                               np.asarray(jpre.iq_gain_balance(iq)), rtol=1e-7)
    np.testing.assert_allclose(preprocessor.preprocess(t).numpy(),
                               np.asarray(jpre.preprocess(iq)), rtol=1e-7, atol=1e-7)
    batch = np.stack([iq, slipped_scene(SEG, 0, "i", seed=1)])   # mean over leading axes
    assert int(preprocessor.detect_iq_error(torch.from_numpy(batch))) == \
        int(jpre.detect_iq_error(batch))


@pytest.mark.parametrize("idx", [0, 1, 2, 3])
def test_streaming_repair_matches_jax_bit_for_bit(idx):
    iq = slipped_scene(3 * SEG, 0, "q")
    carry_j = carry_p = None
    for s in range(3):
        seg = iq[s * SEG:(s + 1) * SEG]
        wr, wi, carry_j = jpre.apply_repair_planar_host(seg.real, seg.imag, idx, carry_j)
        gr, gi, carry_p = preprocessor.apply_repair_planar_host(
            torch.from_numpy(seg.real.copy()), torch.from_numpy(seg.imag.copy()), idx, carry_p)
        assert np.array_equal(gr.numpy(), wr) and np.array_equal(gi.numpy(), wi)
        assert all(np.array_equal(c.numpy(), w) for c, w in zip(carry_p, carry_j))


@pytest.mark.parametrize("slip_at, slip_to, want", [
    (2 * SEG + 1000, None, [0, 0, 0, 0, 2, 2, 2, 2]),    # a slip from mid segment 2 on
    (3 * SEG, 4 * SEG, [0] * 8),                          # one slipped segment: no switch
])
def test_hysteresis_sequence_matches_jax(slip_at, slip_to, want):
    iq = slipped_scene(8 * SEG, slip_at, "q", slip_to=slip_to)
    jc, tc = configs("USB", auto_iq_repair=True, iq_repair_hysteresis=3)
    seq_j, seq_p = [], []
    from radiodsp_sdr_rx_tpu.models.receiver import Receiver as JaxReceiver
    from radiodsp_sdr_rx_tpu_torch.models.receiver import Receiver

    jrx, prx = JaxReceiver(jc), Receiver(tc, device="cpu")
    jst, pst = jrx.init_state(), prx.init_state()
    outs_j, outs_p = [], []
    for s in range(8):
        jo, jst = run_jax(None, iq[s * SEG:(s + 1) * SEG], 1, jst, jrx)[:2]
        po, pst = run_port(None, iq[s * SEG:(s + 1) * SEG], 1, pst, prx)[:2]
        jst, pst = jst[0], pst[0]
        outs_j += jo
        outs_p += po
        seq_j.append(jrx.iq_repair_idx)
        seq_p.append(prx.iq_repair_idx)
    assert seq_p == seq_j == want
    assert_outputs_close(outs_p, outs_j)
