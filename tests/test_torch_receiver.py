"""The port's single-channel ``Receiver`` on the CPU vs the JAX ``Receiver``.

Two threaded segments of 2,048 samples through both, for USB, LSB,
CW_NARROW, AM and SAM (on a carrier locked on the tuned frequency; the PLL
is chaotic on noise) x NR off, NOTCH, DNR2 and SPEC2, and for the noise
blanker (on the decisive impulse scene, the average warm-started), q15
output, mute and the manual I/Q swap. The audio and every state leaf
(``receiver_jax_compare.assert_states_close``) agree to 1e-4, the LMS
weights to 2e-4 (the JAX twin bound, tests/test_pallas_lms.py:35), one q15
step (3.05e-5) aside. The JAX receiver runs its LMS in XLA (one channel per
``lax.scan``); the port runs ``rx_chain_batched`` on a (1, n) view, its LMS
on the plain recurrence here and on the K3 kernel on the card.

Also: a JAX state continues in the port and back (``utils/convert.py``,
unbatched, every fft_length, the conv tails included); ``retune`` keeps the
parameter tensors that did not change and the locked I2S repair, and a
retuned receiver agrees with the retuned JAX one.
"""

import numpy as np
import pytest
import torch
import jax

from radiodsp_sdr_rx_tpu.models.receiver import ReceiverState as JaxReceiverState
from radiodsp_sdr_rx_tpu.models.receiver import rx_chain as jax_rx_chain
from radiodsp_sdr_rx_tpu.ops import lms as jax_lms
from radiodsp_sdr_rx_tpu.ops import planar as jax_planar
from radiodsp_sdr_rx_tpu_torch.models.receiver import Receiver, ReceiverState, rx_chain
from radiodsp_sdr_rx_tpu_torch.utils import convert

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
Q15_STEP = 1.0 / 32768

CASES = {f"{m.lower()}_{nr.lower()}": (m, nr, {}) for m in ("USB", "LSB", "CW_NARROW", "AM", "SAM")
         for nr in ("OFF", "NOTCH", "DNR2", "SPEC2")}
CASES.update({
    "usb_nb": ("USB", "OFF", {"noise_blanker": True, "nb_tau_samples": 256.0}),
    "lsb_q15": ("LSB", "OFF", {"quantize_output": True}),
    "usb_mute": ("USB", "OFF", {"mute": True}),
    "usb_swap": ("USB", "DNR2", {"swap_iq": True}),
})


def _case(name):
    mode, nr, kw = CASES[name]
    jc, tc = configs(mode, nr, **kw)
    iq = scene(mode, 2 * N, sorted(CASES).index(name), impulses=kw.get("noise_blanker", False))
    return jc, tc, iq


def _warm(jc, tc, iq):
    """The blanker's average warm-started on the scene's mean magnitude in
    both packages' initial states (None: the receivers' own)."""
    if not jc.noise_blanker:
        return None, None
    from radiodsp_sdr_rx_tpu.models.receiver import init_state as jax_init_state

    mean = np.float32(np.abs(iq).mean())
    return (jax_init_state(jc.fft_length)._replace(nb_avg=mean),
            Receiver(tc, device="cpu").init_state()._replace(nb_avg=torch.tensor(mean)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_receiver_matches_jax(name):
    jc, tc, iq = _case(name)
    jst, pst = _warm(jc, tc, iq)
    want, jstates, _ = run_jax(jc, iq, 2, jst)
    got, pstates, _ = run_port(tc, iq, 2, pst)
    atol = ATOL + (Q15_STEP if jc.quantize_output else 0.0)
    assert_outputs_close(got, want, atol)
    for p, j in zip(pstates, jstates):
        assert_states_close(p, j)
    mode, nr, kw = CASES[name]
    if kw.get("mute"):
        assert not got[1]["audio_l"].any() and not got[1]["audio_r"].any()
    if kw.get("quantize_output"):
        a = got[1]["audio_l"]
        assert np.array_equal(a, np.round(a * 32768) / 32768)
    if kw.get("noise_blanker"):
        assert float(pstates[1].nb_avg) > 0
    if nr == "DNR2":
        assert np.array_equal(got[1]["audio_l"], got[1]["audio_r"])
    if not kw.get("mute"):
        assert max(float(np.abs(g["audio_l"]).max()) for g in got) > 1e-3


def test_rx_chain_matches_jax_rx_chain():
    """The per-channel function itself: (n,) planes, an unbatched state."""
    jc, tc, iq = _case("am_notch")
    rx = Receiver(tc, device="cpu")
    from radiodsp_sdr_rx_tpu.models.receiver import build_params, init_state

    jp = build_params(jc)
    statics = dict(mode=jc.mode, nr=jc.nr, noise_blanker=False, quantize_output=False)
    xr, xi = iq.real.copy(), iq.imag.copy()
    want, jst = jax.jit(lambda p, st, a, b: jax_rx_chain(p, st, a, b, **statics))(
        jp, init_state(), xr, xi)
    got, st = rx_chain(rx.params, rx.init_state(), torch.from_numpy(xr), torch.from_numpy(xi),
                       **dict(statics, mode=tc.mode, nr=tc.nr))
    assert got["audio_l"].shape == (len(iq),)
    assert_outputs_close([{k: v.numpy() for k, v in got.items()}],
                         [{k: np.asarray(v) for k, v in want.items()}])
    assert_states_close(st, jst)


@pytest.mark.parametrize("name, kw", [
    ("usb_dnr2", {}),
    ("sam_spec2", {"fft_length": 512}),
    ("usb_off", {"conv_first": True, "conv_inline_denoise": True, "fft_length": 1024}),
])
def test_jax_state_continues_in_port_and_back(name, kw):
    mode, nr, extra = CASES[name]
    jc, tc = configs(mode, nr, **extra, **kw)
    iq = scene(mode, 2 * N, 7)
    want, jstates, jrx = run_jax(jc, iq, 2)
    st = convert.state_from_numpy(jstates[0]._asdict(), "cpu")
    assert isinstance(st, ReceiverState) and st.nco_phase.dim() == 0
    assert st.lms.first.dtype == torch.bool and st.conv_tail_r.shape == (jc.fft_length // 2,)
    got, pstates, _ = run_port(tc, iq[N:], 1, st)
    assert_outputs_close(got, want[1:])
    assert_states_close(pstates[0], jstates[1])
    d = convert.state_to_numpy(pstates[0])
    back = JaxReceiverState(**{**d, "lms": jax_lms.LMSState(**d["lms"]),
                               "sam": jax_planar.SAMStatePlanar(**d["sam"])})
    again = convert.state_from_numpy(back, "cpu")
    for a, b in zip(jax.tree_util.tree_leaves(tuple(again)),
                    jax.tree_util.tree_leaves(tuple(pstates[0]))):
        assert torch.equal(a, b)
    jout, _ = jrx.process(iq[:N], back)     # the port's state runs in JAX
    assert np.isfinite(np.asarray(jout["audio_l"])).all()


def test_init_state_matches_jax():
    from radiodsp_sdr_rx_tpu.models.receiver import Receiver as JaxReceiver

    for fft in (128, 256, 1024):
        jc, tc = configs("USB", fft_length=fft)
        want = JaxReceiver(jc).init_state()
        got = convert.state_to_numpy(Receiver(tc, device="cpu").init_state())
        for name, w in want._asdict().items():
            pairs = zip(got[name].values(), w) if name in ("lms", "sam") else [(got[name], w)]
            for g, leaf in pairs:
                np.testing.assert_array_equal(g, leaf)
                assert g.dtype == np.asarray(leaf).dtype and g.shape == np.shape(leaf)


def test_retune_shares_parameters_and_keeps_the_repair():
    """Same statics: the operators' tensors are shared, the DDS word is new,
    the locked repair and its carry survive; the retuned receiver agrees
    with the retuned JAX one. A new mode gives a fresh receiver."""
    from test_torch_preprocessor import slipped_scene

    iq = slipped_scene(4 * N, slip_at=0, which="q")
    jc, tc = configs("USB", auto_iq_repair=True)
    want, jstates, jrx = run_jax(jc, iq[:2 * N], 2)
    got, pstates, rx = run_port(tc, iq[:2 * N], 2)
    assert rx.iq_repair_idx == jrx.iq_repair_idx == 2
    jrx2, rx2 = jrx.retune(vfo_freq=jc.vfo_freq + 300.0), rx.retune(vfo_freq=tc.vfo_freq + 300.0)
    assert rx2.params.w_ssb is rx.params.w_ssb and rx2.params.w_pbt is rx.params.w_pbt
    assert not torch.equal(rx2.params.nco_inc, rx.params.nco_inc)
    assert rx2.iq_repair_idx == 2 and rx2._repair_carry is rx._repair_carry
    want2, _, _ = run_jax(None, iq[2 * N:], 2, jstates[-1], jrx2)
    got2, _, _ = run_port(None, iq[2 * N:], 2, pstates[-1], rx2)
    assert_outputs_close(got2, want2)
    assert jrx2.iq_repair_idx == rx2.iq_repair_idx == 2
    fresh = rx.retune(mode=tc.mode.__class__.LSB)
    assert fresh.iq_repair_idx is None and fresh.params.w_ssb is not rx.params.w_ssb


def test_default_device_is_the_card():
    _, tc = configs("USB")
    if torch.cuda.is_available():
        assert Receiver(tc).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Receiver(tc)
