"""The port's host utilities against the JAX package on the CPU: the file
I/O (``utils/io.py``, bit for bit), checkpoints that either package
writes and the other loads (bit for bit, with the version-skew fallback),
the audio sink without a backend, the native IQ ring built from the port's
own ``csrc/rdsp_io.cpp`` into ``_build/`` (``native/`` untouched),
``utils/profiling`` on the CPU, and the package constants."""

import subprocess
import threading
import wave
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import radiodsp_sdr_rx_tpu as jpkg
import radiodsp_sdr_rx_tpu_torch as pkg
from radiodsp_sdr_rx_tpu.models import channelized as jchannelized
from radiodsp_sdr_rx_tpu.models import metrics as jmetrics
from radiodsp_sdr_rx_tpu.models.config import AGCMode as JAGC
from radiodsp_sdr_rx_tpu.models.config import DemodMode as JDemod
from radiodsp_sdr_rx_tpu.models.config import NRMode as JNR
from radiodsp_sdr_rx_tpu.models.config import ReceiverConfig as JConfig
from radiodsp_sdr_rx_tpu.models.receiver import Receiver as JReceiver
from radiodsp_sdr_rx_tpu.utils import checkpoint as jcheckpoint
from radiodsp_sdr_rx_tpu.utils import io as jio
from radiodsp_sdr_rx_tpu_torch.models.channelized import ChannelizedBank
from radiodsp_sdr_rx_tpu_torch.models.config import AGCMode, DemodMode, NRMode, ReceiverConfig
from radiodsp_sdr_rx_tpu_torch.models.metrics import scope_init
from radiodsp_sdr_rx_tpu_torch.models.receiver import Receiver
from radiodsp_sdr_rx_tpu_torch.utils import audio_sink, build, checkpoint, convert
from radiodsp_sdr_rx_tpu_torch.utils import io, native_io, profiling

FS = 44117.64706
NATIVE = Path(__file__).resolve().parent.parent / "native"


def _iq(n, seed=0, scale=0.4):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * scale).astype(np.complex64)


# ---------------- io ----------------

@pytest.mark.parametrize("channels", [1, 2])
def test_wav_round_trip_equals_jax_bit_for_bit(tmp_path, channels):
    rng = np.random.default_rng(1)
    audio = np.clip(rng.standard_normal((4000, channels)) * 0.4, -1.2, 1.2).astype(np.float32)
    if channels == 1:
        audio = audio[:, 0]
    io.write_wav(str(tmp_path / "port.wav"), audio, FS)
    jio.write_wav(str(tmp_path / "jax.wav"), audio, FS)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    got, fs = io.read_iq_wav(str(tmp_path / "port.wav"))
    want, fs_j = jio.read_iq_wav(str(tmp_path / "port.wav"))
    assert fs == fs_j and got.dtype == want.dtype == np.complex64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", [1, 4])
def test_wav_reader_widths_equal_jax(tmp_path, width):
    rng = np.random.default_rng(2)
    path = str(tmp_path / f"w{width}.wav")
    raw = rng.integers(0, 255, 2 * 300 * width, dtype=np.uint8).tobytes()
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(width)
        w.setframerate(48000)
        w.writeframes(raw)
    got, fs = io.read_iq_wav(path)
    want, fs_j = jio.read_iq_wav(path)
    assert fs == fs_j == 48000.0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["i2", "u1", "f4"])
def test_raw_iq_round_trip_equals_jax_bit_for_bit(tmp_path, dtype):
    iq = _iq(3000, 3)
    io.write_raw_iq(str(tmp_path / "port.cs16"), iq)
    jio.write_raw_iq(str(tmp_path / "jax.cs16"), iq)
    assert (tmp_path / "port.cs16").read_bytes() == (tmp_path / "jax.cs16").read_bytes()
    path = str(tmp_path / "raw.bin")
    np.random.default_rng(4).integers(0, 255, 4000, dtype=np.uint8).tofile(path)
    if dtype == "f4":
        np.ascontiguousarray(np.stack([iq.real, iq.imag], -1), "<f4").tofile(path)
    np.testing.assert_array_equal(io.read_raw_iq(path, dtype), jio.read_raw_iq(path, dtype))


# ---------------- checkpoints ----------------

def _jax_states():
    """A JAX ReceiverState (DNR2, a processed block), ScopeState and
    ChannelizedState (SSB, two segments), each past its initial values."""
    cfg = JConfig(mode=JDemod.USB, vfo_freq=7_060_000.0, capture_center_freq=7_050_000.0,
                  agc=JAGC.FAST, nr=JNR.DNR2)
    rx = JReceiver(cfg)
    _, rx_state = rx.process(jnp.asarray(_iq(4096, 5, 0.1)), rx.init_state())
    _, scope = jmetrics.analyze_jit(jnp.asarray(_iq(128 * 30, 6, 0.1)),
                                    jnp.asarray(_iq(512 * 8, 7).real), jmetrics.scope_init())
    bank = jchannelized.ChannelizedBank(8, demod="ssb", agc="medium",
                                        offsets_hz=np.linspace(-2000, 2000, 8))
    ch = bank.init_state()
    for seg in range(2):
        _, ch = bank.process(_iq(512, 8 + seg), ch)
    return cfg, {"receiver": rx_state, "scope": scope, "channelized": ch}


def _port_templates():
    cfg = ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_060_000.0,
                         capture_center_freq=7_050_000.0, agc=AGCMode.FAST, nr=NRMode.DNR2)
    return cfg, {"receiver": Receiver(cfg, device="cpu").init_state(),
                 "scope": scope_init("cpu"),
                 "channelized": ChannelizedBank(8, demod="ssb", device="cpu").init_state()}


def _flat_jax(state):
    return {jcheckpoint._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(state)[0]}


def test_checkpoint_keys_are_jax_path_strings():
    _, jstates = _jax_states()
    _, templates = _port_templates()
    for name, tmpl in templates.items():
        keys = [k for k, _ in checkpoint.flatten_with_paths(tmpl)]
        assert keys == list(_flat_jax(jstates[name])), name
    assert checkpoint.flatten_with_paths({"b": [1, None, (2,)], "a": None}) == [
        ("b/0", 1), ("b/2/0", 2)]


def test_jax_checkpoints_load_in_the_port_bit_for_bit(tmp_path):
    jcfg, jstates = _jax_states()
    cfg, templates = _port_templates()
    for name, jstate in jstates.items():
        path = str(tmp_path / f"{name}.npz")
        jcheckpoint.save_state(path, jstate, jcfg)
        state, got_cfg = checkpoint.load_state(path, templates[name])
        assert got_cfg == cfg
        want = _flat_jax(jstate)
        for key, leaf in checkpoint.flatten_with_paths(state):
            tmpl = dict(checkpoint.flatten_with_paths(templates[name]))[key]
            assert leaf.dtype == tmpl.dtype and leaf.device == tmpl.device, key
            np.testing.assert_array_equal(leaf.numpy().astype(want[key].dtype), want[key])
        # the same state as the carry-across of utils/convert
        for a, b in zip(checkpoint.flatten_with_paths(state), checkpoint.flatten_with_paths(
                convert.state_from_numpy(_fields(jstate), "cpu"))):
            assert a[0] == b[0] and torch.equal(a[1], b[1])


def _fields(state):
    return {k: _fields(v) if hasattr(v, "_asdict") else np.asarray(v)
            for k, v in state._asdict().items()}


def test_port_checkpoints_load_in_jax_bit_for_bit(tmp_path):
    jcfg, jstates = _jax_states()
    cfg, _ = _port_templates()
    for name, jstate in jstates.items():
        port_state = convert.state_from_numpy(_fields(jstate), "cpu")
        path = str(tmp_path / f"{name}.npz")
        checkpoint.save_state(path, port_state, cfg)
        with np.load(path) as data:
            assert set(data) == set(_flat_jax(jstate)) | {"__config__"}
        state, got_cfg = jcheckpoint.load_state(path, jstate)
        assert got_cfg == jcfg
        got, want = _flat_jax(state), _flat_jax(jstate)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key])


def test_checkpoint_version_skew_takes_the_template_leaf(tmp_path):
    """An old checkpoint without a leaf loads: that leaf is the template's."""
    _, jstates = _jax_states()
    _, templates = _port_templates()
    path = str(tmp_path / "new.npz")
    jcheckpoint.save_state(path, jstates["receiver"])
    with np.load(path) as data:
        data = dict(data)
    dropped = "conv_tail_r"
    del data[dropped]
    np.savez(str(tmp_path / "old.npz"), **data)
    state, cfg = checkpoint.load_state(str(tmp_path / "old.npz"), templates["receiver"])
    assert cfg is None
    assert state.conv_tail_r is templates["receiver"].conv_tail_r
    np.testing.assert_array_equal(state.sb_tail_r.numpy(), data["sb_tail_r"])
    assert state.nco_phase.dtype == torch.int64 and int(state.nco_phase) == int(data["nco_phase"])


def test_resume_from_a_checkpoint_is_exact(tmp_path):
    """A port Receiver checkpointed mid-stream and restored in a new one
    continues bit for bit as the unbroken stream."""
    cfg = ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_060_000.0,
                         capture_center_freq=7_050_000.0, agc=AGCMode.FAST, nr=NRMode.DNR2)
    rx = Receiver(cfg, device="cpu")
    iq = _iq(3 * 4096, 9, 0.1)
    _, st = rx.process(iq[:4096], rx.init_state())
    out_full, _ = rx.process(iq[4096:], st)
    path = str(tmp_path / "mid.npz")
    checkpoint.save_state(path, st, cfg)
    state2, cfg2 = checkpoint.load_state(path, rx.init_state())
    out_resumed, _ = Receiver(cfg2, device="cpu").process(iq[4096:], state2)
    for k in out_full:
        assert torch.equal(out_resumed[k], out_full[k]), k


def test_config_json_crosses_both_ways():
    jcfg = JConfig(mode=JDemod.SAM, nr=JNR.SPEC3, pbt_lo=450.0, pbt_hi=3800.0)
    cfg = ReceiverConfig(mode=DemodMode.SAM, nr=NRMode.SPEC3, pbt_lo=450.0, pbt_hi=3800.0)
    assert checkpoint.config_to_json(cfg) == jcheckpoint.config_to_json(jcfg)
    assert checkpoint.config_from_json(jcheckpoint.config_to_json(jcfg)) == cfg
    assert jcheckpoint.config_from_json(checkpoint.config_to_json(cfg)) == jcfg


def test_dds_words_outside_32_bits_are_refused(tmp_path):
    st = scope_init("cpu")
    bad = ChannelizedBank(8, demod="am", device="cpu").init_state()
    bad = bad._replace(nco=torch.full((8,), -1, dtype=torch.int64))
    checkpoint.save_state(str(tmp_path / "ok.npz"), st)
    with pytest.raises(ValueError, match="DDS words"):
        checkpoint.save_state(str(tmp_path / "bad.npz"), bad)


# ---------------- the audio sink ----------------

def test_audio_sink_without_a_backend(monkeypatch):
    """Neither environment has sounddevice, aplay, paplay or ffplay: the
    sink reports unavailable and writes are no-ops."""
    monkeypatch.setattr(audio_sink.shutil, "which", lambda name: None)
    sink = audio_sink.AudioSink(FS)
    assert not sink.available and sink.backend is None
    sink.write(np.zeros(256, np.float32))
    sink.write(torch.zeros(256))
    sink.close()
    assert sink.stats == {"written": 0, "dropped": 0, "backend": None}


def test_audio_sink_pipes_tensors_to_a_command(tmp_path):
    out = tmp_path / "sink.pcm"
    sink = audio_sink.AudioSink(FS, channels=2, command=["/bin/sh", "-c", f"cat > {out}"])
    assert sink.available and sink.backend == "/bin/sh"
    block = torch.linspace(-0.9, 0.9, 1024)
    sink.write(block)
    sink.write(block.numpy())
    sink.close()
    data = np.frombuffer(out.read_bytes(), "<i2").reshape(-1, 2)
    assert data.shape == (2048, 2) and np.array_equal(data[:1024], data[1024:])
    np.testing.assert_array_equal(data[:1024, 0], (block.numpy() * 32767.0).astype("<i2"))
    assert sink.stats["written"] == 2048 and sink.stats["dropped"] == 0


# ---------------- the native ring ----------------

def _snapshot(root: Path):
    return sorted((p.name, p.stat().st_mtime_ns, p.stat().st_size) for p in root.iterdir())


@pytest.fixture
def ring_lib(tmp_path, monkeypatch):
    """The ring's library built afresh into a build directory of its own,
    every compiler call recorded."""
    calls = []
    run = subprocess.run

    def recorded(cmd, *args, **kwargs):
        calls.append(list(cmd))
        return run(cmd, *args, **kwargs)

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build.subprocess, "run", recorded)
    monkeypatch.setattr(native_io, "_lib", None)
    before = _snapshot(NATIVE)
    lib = native_io.load()
    return lib, calls, before


def test_ring_builds_from_the_port_source_into_build(ring_lib):
    lib, calls, before = ring_lib
    so = build.host_artifact("rdsp_io")
    assert so.exists() and so.parent == build.BUILD_DIR and Path(lib._name) == so
    assert len(calls) == 1 and calls[0][0] == "g++"
    out = Path(calls[0][calls[0].index("-o") + 1])
    assert out.parent == build.BUILD_DIR
    assert Path(calls[0][calls[0].index("-o") + 2]) == build.CSRC / "rdsp_io.cpp"
    assert not any(str(NATIVE) in " ".join(c) for c in calls)
    assert _snapshot(NATIVE) == before            # native/: the same files, the same mtimes
    assert build.BUILD_DIR.name == "_build"
    # the port's source is the JAX package's, bar its header comment
    ours = (build.CSRC / "rdsp_io.cpp").read_text().split("#include <atomic>", 1)[1]
    theirs = (NATIVE / "rdsp_io.cpp").read_text().split("#include <atomic>", 1)[1]
    assert ours == theirs


def _q15(x):
    return np.clip(np.trunc(x * 32768), -32768, 32767).astype(np.float32) / 32768


def test_ring_round_trip_overrun_and_wrap(ring_lib):
    iq = _iq(256, 10, 0.5)   # some samples past full scale: clipped
    ring = native_io.IQRing(1024)
    assert ring.push_complex(iq) == 256 and ring.available == 256
    out = ring.pop_complex(256)
    np.testing.assert_array_equal(out.real, _q15(iq.real))
    np.testing.assert_array_equal(out.imag, _q15(iq.imag))
    assert (np.abs(iq.real) >= 1).any()
    ring.close()
    ring = native_io.IQRing(100)
    assert ring.push_complex(np.full(150, 0.1, np.complex64)) == 100
    assert ring.stats == {"pushed": 100, "popped": 0, "dropped": 50, "available": 100}
    ring.close()
    ring = native_io.IQRing(128)
    for k in range(10):   # past the end of the buffer, several times
        block = _iq(96, 20 + k, 0.2)
        ring.push_complex(block)
        np.testing.assert_array_equal(ring.pop_complex(96).real, _q15(block.real))
    ring.close()


def test_ring_q15_and_wav_reader(ring_lib, tmp_path):
    f = np.linspace(-1.2, 1.2, 1001, dtype=np.float32)
    q = native_io.float_to_q15_native(f)
    np.testing.assert_array_equal(q, np.clip(np.trunc(f * 32768.0), -32768, 32767).astype(np.int16))
    np.testing.assert_array_equal(native_io.q15_to_float_native(q), q.astype(np.float32) / 32768.0)
    iq = _iq(1000, 11)
    path = str(tmp_path / "cap.wav")
    io.write_wav(path, np.stack([iq.real, iq.imag], -1), FS)
    reader = native_io.NativeWavReader(path)
    assert reader.sample_rate == int(round(FS)) and reader.channels == 2
    got = reader.read_complex(2000)
    reader.close()
    np.testing.assert_array_equal(got, io.read_iq_wav(path)[0])


def test_ring_threaded_producer_consumer(ring_lib):
    """A capture thread pushes, the feeder pops 128-sample blocks: nothing
    lost, nothing reordered."""
    ring = native_io.IQRing(4096)
    blocks, block = 200, 128
    src = (np.arange(blocks * block) % 1000 / 2000.0).astype(np.float32)
    src_iq = (src + 1j * src).astype(np.complex64)

    def producer():
        for b in range(blocks):
            seg = src_iq[b * block:(b + 1) * block]
            while len(seg):
                seg = seg[ring.push_complex(seg):]

    t = threading.Thread(target=producer)
    t.start()
    out, got = [], 0
    while got < blocks * block:
        chunk = ring.pop_complex(block)
        out.append(chunk)
        got += len(chunk)
    t.join(timeout=30)
    assert not t.is_alive()
    np.testing.assert_array_equal(np.concatenate(out).real, _q15(src))
    assert ring.stats["popped"] == blocks * block
    ring.close()


# ---------------- profiling ----------------

def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir), device="cpu"):
        torch.ones(32, 32) @ torch.ones(32, 32)
    files = list(logdir.glob("trace_*.json"))
    assert len(files) == 1 and "aten::mm" in files[0].read_text()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            with profiling.trace(str(logdir)):
                pass


# ---------------- the package ----------------

def test_package_constants_equal_jax():
    for name in ("__version__", "SAMPLE_RATE", "BLOCK_SIZE", "FFT_LENGTH"):
        assert getattr(pkg, name) == getattr(jpkg, name), name
        assert name in pkg.__all__
