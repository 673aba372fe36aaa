"""The port's ``Receiver`` and ``ReceiverBank`` at fft_length 128, 512 and
1,024 (blocks of 64, 256 and 512 samples) vs the JAX package on the CPU.

Every stage frames by its operator's shape, as the JAX chain does
(``ops/planar.py:79-125``): the band-pass and SSB operators (2F, F) and
(2F, F/2), the PBT (F, F), the spectral subtraction's F-point DFT (its VAD
band, bins 30-180, clipped to the frame at F = 128 as slicing clips it in
both packages). NR off, DNR2 and SPEC2, two threaded segments of 2,048
samples, audio and every state leaf at 1e-4 (LMS weights 2e-4), the bounds
of tests/test_torch_receiver.py. The bank (4 channels) against the JAX
``ReceiverBank(backend="vmap")``, the per-channel XLA chain.
"""

import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu.models.receiver import ReceiverBank as JaxReceiverBank
from radiodsp_sdr_rx_tpu_torch.models.receiver import ReceiverBank

from receiver_jax_compare import (
    ATOL,
    assert_outputs_close,
    assert_states_close,
    configs,
    run_jax,
    run_port,
    scene,
)

N = 2048
FFTS = (128, 512, 1024)
NRS = ("OFF", "DNR2", "SPEC2")


@pytest.mark.parametrize("nr", NRS)
@pytest.mark.parametrize("fft", FFTS)
def test_receiver_matches_jax(fft, nr):
    jc, tc = configs("USB", nr, fft_length=fft)
    iq = scene("USB", 2 * N, fft + len(nr))
    want, jstates, _ = run_jax(jc, iq, 2)
    got, pstates, rx = run_port(tc, iq, 2)
    assert rx.params.w_ssb.shape == (2 * fft, fft // 2) and rx.params.w_pbt.shape == (fft, fft)
    assert pstates[1].audio_tail.shape == (fft // 2,)
    assert_outputs_close(got, want)
    for p, j in zip(pstates, jstates):
        assert_states_close(p, j)


@pytest.mark.parametrize("nr", NRS)
@pytest.mark.parametrize("fft", FFTS)
def test_bank_matches_jax(fft, nr):
    jc, tc = configs("LSB", nr, fft_length=fft, agc="FAST")
    freqs = [jc.vfo_freq - 1_500.0 * k for k in range(4)]
    rng = np.random.default_rng(fft)
    iq = scene("LSB", 2 * N, fft)[None] + (rng.standard_normal((4, 2 * N)) * 0.02).astype(
        np.complex64)
    jb = JaxReceiverBank(jc, freqs, backend="vmap")
    pb = ReceiverBank(tc, freqs, device="cpu")
    jst, pst = jb.init_state(), pb.init_state()
    assert pst.sb_tail_r.shape == (4, fft // 2)
    for s in range(2):
        want, jst = jb.process(iq[:, s * N:(s + 1) * N], jst)
        got, pst = pb.process(iq[:, s * N:(s + 1) * N], pst)
        for key in ("audio_l", "audio_r"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL, rtol=0)
        assert_states_close(pst, jst)


def test_segment_must_be_a_multiple_of_the_block():
    _, tc = configs("USB", fft_length=1024)
    rx = run_port(tc, np.zeros(1024, np.complex64), 1)[2]
    with pytest.raises(ValueError, match="multiple of fft_length/2"):
        rx.process(np.zeros(768, np.complex64), rx.init_state())
