"""The port's ``StreamingReceiver`` (``models/streaming.py``) on the CPU
against the JAX package's.

Both push the same seeded capture through their native q15 rings and
demodulate it in blocks. The rings are one C++ source, built here once, in
the port's ``_build/``: the JAX ring loads that build, so no test writes into
``native/``, which each test holds unchanged, and the blocks both pop are
equal bit for bit. Tolerances: the audio within ATOL (1e-4) of the JAX stream's, the
bound of the ``Receiver`` parity tests (``tests/receiver_jax_compare.py``;
2e-4 with an LMS stage); the stream within 2e-3 of the direct ``Receiver``
on the unquantised capture (the q15 ring, ``tests/test_streaming.py:39``);
the port's threaded producer, and the back-pressured push, bit for bit its
own ``run_file``; the scope's IQ metrics within 5e-6 of their peak of the
JAX stream's (``tests/test_torch_scopes.py``), its audio spectrum, whose
input differs by the audio's bound, within 1e-3 of its peak.
"""

import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu.models.streaming import StreamingReceiver as JaxStreamingReceiver
from radiodsp_sdr_rx_tpu.utils import native_io as jnative_io
from radiodsp_sdr_rx_tpu.utils import siggen
from radiodsp_sdr_rx_tpu_torch.models.receiver import Receiver
from radiodsp_sdr_rx_tpu_torch.models.streaming import StreamingReceiver
from radiodsp_sdr_rx_tpu_torch.utils import native_io

from receiver_jax_compare import ATOL, LMS_ATOL, configs

ROOT = Path(__file__).resolve().parent.parent
N = 1 << 16
RING_TOL = 2e-3       # the q15 ring against the unquantised capture
SCOPE_TOL = 5e-6      # of the peak: the IQ metrics, same inputs
AUDIO_SCOPE_TOL = 1e-3  # of the peak: the audio scope, inputs within ATOL


@pytest.fixture(autouse=True)
def jax_ring_from_the_port_build(monkeypatch):
    """The JAX package's ring loads the port's build of the same C++ source
    (``csrc/rdsp_io.cpp``, a copy of ``native/rdsp_io.cpp``), so that these
    tests never build into ``native/``; they hold ``native/`` unchanged."""
    monkeypatch.setattr(jnative_io, "ensure_built", native_io.ensure_built)
    monkeypatch.setattr(jnative_io, "_lib", None)
    before = _native_files()
    yield
    assert _native_files() == before


def _native_files():
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns)
            for p in (ROOT / "native").iterdir()}


def _capture(n, seed=0):
    audio_in = siggen.voice_like(n, 44117.64706, seed=seed)
    iq = siggen.ssb_from_audio(audio_in, 2_000.0, 44117.64706, "usb", amp=0.4)
    return (iq + siggen.noise(n, 0.01, seed)).astype(np.complex64)


CASES = {"usb_fast_8192": ("USB", "OFF", "FAST", 8192),
         "usb_medium_16384": ("USB", "OFF", "MEDIUM", 16384),
         "lsb_dnr2_8192": ("LSB", "DNR2", "MEDIUM", 8192)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_file_matches_jax(case):
    mode, nr, agc, block = CASES[case]
    jc, tc = configs(mode, nr, agc)
    iq = _capture(N, sorted(CASES).index(case))
    ref = JaxStreamingReceiver(jc, block=block)
    sr = StreamingReceiver(tc, block=block, device="cpu")
    want = ref.run_file(iq, chunk=20000)
    got = sr.run_file(iq, chunk=20000)
    assert got.dtype == np.float32 and len(got) == len(want) == N
    np.testing.assert_allclose(got, want, atol=LMS_ATOL if nr != "OFF" else ATOL, rtol=0)
    assert sr.stats == ref.stats and sr.stats["dropped"] == 0
    # and against the direct Receiver on the unquantised capture
    rx = Receiver(tc, device="cpu")
    direct = rx.process(iq, rx.init_state())[0]["audio_l"].numpy()
    np.testing.assert_allclose(got, direct, atol=RING_TOL, rtol=0)
    sr.close()
    ref.close()


def test_threaded_producer_equals_run_file():
    jc, tc = configs("USB", "OFF", "FAST")
    iq = _capture(N, 5)
    sr = StreamingReceiver(tc, block=8192, ring_capacity=1 << 15, device="cpu")
    outs = []

    def producer():
        pos = 0
        while pos < N:
            pos += sr.push(iq[pos:pos + 4096])

    t = threading.Thread(target=producer)
    t.start()
    total = 0
    while total < N:
        for chunk in sr.process_available():
            assert isinstance(chunk, np.ndarray) and chunk.dtype == np.float32
            total += len(chunk)
            outs.append(chunk)
    t.join()
    threaded = np.concatenate(outs)
    # the ring counts a refused push as dropped; the producer retried it
    assert len(threaded) == sr.stats["popped"] == N
    sr.close()
    one = StreamingReceiver(tc, block=8192, device="cpu")
    np.testing.assert_array_equal(threaded, one.run_file(iq))
    one.close()
    ref = JaxStreamingReceiver(jc, block=8192)
    np.testing.assert_allclose(threaded, ref.run_file(iq), atol=ATOL, rtol=0)
    ref.close()


def test_push_backpressure_equals_run_file():
    _, tc = configs("USB", "OFF", "MEDIUM")
    iq = _capture(N, 6)
    sr = StreamingReceiver(tc, block=4096, ring_capacity=3 * 4096, device="cpu")
    outs = []
    sr.process_available = _collecting(sr.process_available, outs)
    sr.push_backpressure(iq)    # drains in this thread whenever the ring is full
    sr.process_available()
    assert sum(len(o) for o in outs) == sr.stats["popped"] == N
    one = StreamingReceiver(tc, block=4096, device="cpu")
    np.testing.assert_array_equal(np.concatenate(outs), one.run_file(iq))
    sr.close()
    one.close()


def _collecting(fn, outs):
    def run():
        got = fn()
        outs.extend(got)
        return got
    return run


def test_metrics_during_streaming_match_jax():
    jc, tc = configs("USB", "OFF", "MEDIUM")
    iq = _capture(N, 7)
    # 16,384-sample blocks: 32 audio frames, one audio scope row a block
    ref = JaxStreamingReceiver(jc, block=16384, metrics=True)
    sr = StreamingReceiver(tc, block=16384, metrics=True, device="cpu")
    np.testing.assert_allclose(sr.run_file(iq), ref.run_file(iq), atol=ATOL, rtol=0)
    got, want = sr.last_metrics, ref.last_metrics
    assert got is not None and got["waterfall"].shape == (50, 128)
    assert all(torch.is_tensor(v) and v.device.type == "cpu" for v in got.values())
    assert sr.scope.view_old.device.type == "cpu"
    for key, tol in (("spectrum", SCOPE_TOL), ("view", SCOPE_TOL), ("waterfall", SCOPE_TOL),
                     ("smeter_uv", SCOPE_TOL), ("audio_spectrum", AUDIO_SCOPE_TOL)):
        w = np.asarray(want[key])
        assert got[key].shape == w.shape and w.size, key
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=tol * float(np.abs(w).max()), err_msg=key)
    np.testing.assert_array_equal(got["waterfall_cls"].numpy(), np.asarray(want["waterfall_cls"]))
    sr.close()
    ref.close()


def test_block_must_be_a_multiple_of_128():
    _, tc = configs("USB")
    with pytest.raises(ValueError):
        StreamingReceiver(tc, block=1000, device="cpu")
