"""The conv-first variants (the backup sketch's graph ordering) on the CPU
vs the JAX package, and the inline denoise against the reference's own
loop.

``conv_first`` runs the audio band-pass as a complex overlap-save filter on
the mixed IQ before the demod and skips the PBT (L = R = the AGC's output,
the PBT tail carried unchanged); ``conv_inline_denoise`` replaces that
filter by the inline spectral denoise. The port's ``Receiver`` and
``ReceiverBank`` against the JAX ones over two threaded segments of 2,048
samples: 1e-4, LMS weights 2e-4, the mixed blocks carried in ``conv_tail``
to 1e-6 (tests/receiver_jax_compare.py). ``inline_denoise_planar``
against ``tests/reference_oracle.inline_denoise_loop`` (float64 numpy, the
transcribed Conv.ino:1520-1650) under the JAX test's own bound
(tests/test_reference_chain.py:78-98): the rms of the difference under 2e-3
of the signal's, since a bin within rounding of the threshold takes the
other branch in f32; against the JAX function at 1e-5.
"""

import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu.models.receiver import ReceiverBank as JaxReceiverBank
from radiodsp_sdr_rx_tpu.ops import planar as jax_planar
from radiodsp_sdr_rx_tpu_torch.models.receiver import ReceiverBank
from radiodsp_sdr_rx_tpu_torch.ops import planar

from reference_oracle import inline_denoise_loop
from receiver_jax_compare import (
    ATOL,
    FS,
    assert_outputs_close,
    assert_states_close,
    configs,
    run_jax,
    run_port,
    scene,
)

N = 2048
CASES = [
    ("USB", "OFF", False), ("USB", "OFF", True), ("LSB", "DNR2", False),
    ("AM", "SPEC2", True), ("SAM", "NOTCH", False), ("CW_NARROW", "OFF", True),
]


@pytest.mark.parametrize("mode, nr, inline", CASES)
def test_receiver_matches_jax(mode, nr, inline):
    jc, tc = configs(mode, nr, conv_first=True, conv_inline_denoise=inline)
    iq = scene(mode, 2 * N, len(mode) + 3 * inline)
    want, jstates, _ = run_jax(jc, iq, 2)
    got, pstates, _ = run_port(tc, iq, 2)
    assert_outputs_close(got, want)
    for p, j in zip(pstates, jstates):
        assert_states_close(p, j)
    assert not pstates[1].audio_tail.any()          # no PBT stage ran
    assert pstates[1].conv_tail_r.abs().max() > 0
    if nr == "OFF":
        assert np.array_equal(got[1]["audio_l"], got[1]["audio_r"])


@pytest.mark.parametrize("inline", [False, True])
def test_bank_matches_jax(inline):
    jc, tc = configs("USB", "SPEC2", conv_first=True, conv_inline_denoise=inline)
    freqs = [jc.vfo_freq + 2_000.0 * k for k in range(3)]
    iq = np.stack([scene("USB", 2 * N, k) for k in range(3)])
    jb, pb = JaxReceiverBank(jc, freqs, backend="vmap"), ReceiverBank(tc, freqs, device="cpu")
    jst, pst = jb.init_state(), pb.init_state()
    for s in range(2):
        want, jst = jb.process(iq[:, s * N:(s + 1) * N], jst)
        got, pst = pb.process(iq[:, s * N:(s + 1) * N], pst)
        for key in ("audio_l", "audio_r"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL, rtol=0)
        assert_states_close(pst, jst)


@pytest.mark.parametrize("split_dft", [True, False])
def test_inline_denoise_matches_the_reference_loop(split_dft):
    rng = np.random.default_rng(11)
    n = 2048
    t = np.arange(n) / FS
    iq = (0.3 * np.exp(2j * np.pi * 1000.0 * t)
          + (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.03).astype(np.complex64)
    want_r, want_i = inline_denoise_loop(iq.real, iq.imag)
    c, s = (torch.from_numpy(a) for a in planar.dft_matrices(256))
    xr, xi = torch.from_numpy(iq.real.copy())[None], torch.from_numpy(iq.imag.copy())[None]
    zero = torch.zeros(1, 128)
    got_r, got_i, tail_r, tail_i = planar.inline_denoise_planar(xr, xi, c, s, zero, zero,
                                                               split_dft=split_dft)
    err = np.concatenate([got_r[0].numpy() - want_r, got_i[0].numpy() - want_i])
    sig = np.concatenate([want_r, want_i])
    assert float(np.sqrt(np.mean(err ** 2))) < 2e-3 * max(1.0, float(np.sqrt(np.mean(sig ** 2))))
    assert torch.equal(tail_r, xr[:, -128:]) and torch.equal(tail_i, xi[:, -128:])
    jw = jax_planar.inline_denoise_planar(iq.real[None], iq.imag[None], c.numpy(), s.numpy(),
                                          zero.numpy(), zero.numpy(), split_dft=split_dft)
    for g, w in zip((got_r, got_i), jw[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
