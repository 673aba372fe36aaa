"""The port's CLI (``cli.py``, ``__main__.py``) on the CPU against the JAX
package's, and the port's packaging.

Each subcommand runs through the JAX ``main`` and the port's
``main(argv, device="cpu")`` on the same seeded capture file. Tolerances:
the written WAVs within one q15 count a sample (the audio agrees within
1e-4, 2e-4 with an LMS stage, before both quantise it); the scope, scan and
tui text equal; the printed summary lines equal but for their timings.
``info`` names the port and the CUDA cards torch sees. The JAX ``stream``
takes its ring from the port's build of the same C++ source, so no test
writes into ``native/``, which each test holds unchanged. Without a card,
``main`` with no device raises ``resolve_device``'s error; the module runs
as ``python -m radiodsp_sdr_rx_tpu_torch``.

The packaging: every subpackage of the port that the packaged modules
import is listed in ``pyproject.toml`` (``radiodsp_sdr_rx_tpu_torch.parallel``
was not), and the port's console script resolves to a callable.
"""

import ast
import contextlib
import importlib
import io
import os
import re
import subprocess
import sys
import tomllib
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu.cli import main as jax_main
from radiodsp_sdr_rx_tpu.utils import io as io_utils
from radiodsp_sdr_rx_tpu.utils import native_io as jnative_io
from radiodsp_sdr_rx_tpu.utils import siggen
from radiodsp_sdr_rx_tpu_torch import __version__
from radiodsp_sdr_rx_tpu_torch.cli import main
from radiodsp_sdr_rx_tpu_torch.utils import native_io

ROOT = Path(__file__).resolve().parent.parent
FS = 44117.64706
N = 1 << 16
Q15 = 32768


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


def _run(fn, argv, **kw):
    """(return code, stdout) of one CLI call."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv, **kw)
    return rc, buf.getvalue()


def _untimed(text):
    """The printout with its timings taken out."""
    text = re.sub(r"\[\d+\.\d+s, \d+x real time\]", "[timing]", text)
    return re.sub(r"in \d+\.\d+s", "in (timing)", text)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """A USB voice 10 kHz above the centre, a 1 kHz tone 4 kHz below it and
    an AM carrier 15 kHz above, in weak noise: a stereo WAV and raw cs16."""
    d = tmp_path_factory.mktemp("cli")
    t = np.arange(N) / FS
    iq = (siggen.ssb_from_audio(siggen.voice_like(N, FS, seed=3), 10_000.0, FS, "usb", amp=0.3)
          + 0.1 * np.exp(2j * np.pi * -3_000.0 * t)
          + siggen.am_signal(N, 15_000.0, mod_hz=400.0, fs=FS, amp=0.2)
          + siggen.noise(N, 0.01, 3)).astype(np.complex64)
    wav = str(d / "capture.wav")
    io_utils.write_wav(wav, np.stack([iq.real, iq.imag], 1), FS)
    raw = str(d / "capture.cs16")
    inter = np.empty(2 * N, "<i2")
    inter[0::2] = np.clip(np.round(iq.real * 32767), -32768, 32767)
    inter[1::2] = np.clip(np.round(iq.imag * 32767), -32768, 32767)
    inter.tofile(raw)
    return {"wav": wav, "raw": raw, "dir": d}


def _wav_counts(path):
    with wave.open(path, "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.int32)


RX = ["--vfo", "7060000", "--center", "7050000"]
DEMOD = {
    "usb_medium": ["--mode", "usb"],
    "lsb_dnr2": ["--mode", "lsb", "--vfo", "7046000", "--nr", "dnr2"],
    "am_notch_raw": ["--mode", "am", "--vfo", "7065000", "--nr", "notch", "--raw"],
    "cw_spec2_fast": ["--mode", "cw", "--agc", "fast", "--nr", "spec2", "--no-iq-repair"],
}


@pytest.mark.parametrize("sub", ["demod", "stream"])
@pytest.mark.parametrize("case", sorted(DEMOD))
def test_demod_and_stream_wavs_match_jax(capture, case, sub):
    argv = [sub, capture["raw" if "--raw" in DEMOD[case] else "wav"]] + RX + DEMOD[case]
    outs = {}
    for name, fn, kw in (("jax", jax_main, {}), ("port", main, {"device": "cpu"})):
        out = str(capture["dir"] / f"{sub}_{case}_{name}.wav")
        rc, text = _run(fn, argv + ["--out", out], **kw)
        assert rc == 0
        outs[name] = (_wav_counts(out), _untimed(text).replace(f"_{name}.wav", ".wav"))
    (got, got_text), (want, want_text) = outs["port"], outs["jax"]
    assert got_text == want_text
    assert got.shape == want.shape and got.size >= N // 2
    assert np.abs(got - want).max() <= 1      # one q15 count
    assert np.abs(got).max() > 0.01 * Q15     # there is audio


@pytest.mark.parametrize("extra", [[], ["--dual"], ["--dual", "--mode", "am", "--vfo", "7065000"]],
                         ids=["pan", "dual_usb", "dual_am"])
def test_scope_text_matches_jax(capture, extra):
    argv = ["scope", capture["wav"]] + RX + extra
    rc_j, want = _run(jax_main, argv)
    rc, got = _run(main, argv, device="cpu")
    assert rc == rc_j == 0
    assert got == want
    assert "S-meter" in got and ("AF-FFT" in got) == bool(extra)


@pytest.mark.parametrize("channels", [16, 64])
def test_scan_text_matches_jax(capture, channels):
    argv = ["scan", capture["wav"], "--center", "7050000", "--channels", str(channels)]
    rc_j, want = _run(jax_main, argv)
    rc, got = _run(main, argv, device="cpu")
    assert rc == rc_j == 0
    assert got == want
    assert len(re.findall(r"  ch +\d+", got)) >= 3   # the three planted stations


def test_tui_frames_match_jax(capture):
    argv = ["tui", capture["wav"]] + RX + ["--frames", "6", "--block", "4096"]
    rc_j, want = _run(jax_main, argv)
    rc, got = _run(main, argv, device="cpu")
    assert rc == rc_j == 0
    assert got == want
    assert got.count("S-meter:") == 6 and "[USB]" in got


def test_info_names_the_port():
    rc, text = _run(main, ["info"], device="cpu")
    assert rc == 0
    assert f"radiodsp_sdr_rx_tpu_torch {__version__}" in text
    assert f"torch {torch.__version__}" in text and "CUDA devices: " in text
    if not torch.cuda.is_available():
        assert "CUDA devices: none" in text
    else:
        assert torch.cuda.get_device_name(0) in text


@pytest.mark.parametrize("sub", ["demod", "scope", "stream", "tui", "scan"])
def test_no_device_raises_without_a_card(capture, sub):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: main without a device runs on it")
    argv = [sub, capture["wav"]] + (["--out", str(capture["dir"] / "x.wav")]
                                    if sub in ("demod", "stream") else [])
    argv += ["--frames", "1"] if sub == "tui" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_python_dash_m_runs_info():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    got = subprocess.run([sys.executable, "-m", "radiodsp_sdr_rx_tpu_torch", "info"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert got.returncode == 0, got.stderr
    assert got.stdout.startswith(f"radiodsp_sdr_rx_tpu_torch {__version__}\n")


def _imported_port_packages(path: Path):
    """The port's packages that the module at ``path`` imports from."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
        for name in names:
            if name.split(".")[0] != "radiodsp_sdr_rx_tpu_torch":
                continue
            target = ROOT.joinpath(*name.split("."))
            if (target / "__init__.py").exists():
                yield name
            elif target.with_suffix(".py").exists():
                yield name.rpartition(".")[0]


def test_pyproject_packages_every_imported_subpackage():
    meta = tomllib.loads((ROOT / "pyproject.toml").read_text())
    listed = set(meta["tool"]["setuptools"]["packages"])
    port = {p for p in listed if p.split(".")[0] == "radiodsp_sdr_rx_tpu_torch"}
    assert "radiodsp_sdr_rx_tpu_torch.parallel" in port
    imported = set()
    for pkg in port:
        assert (ROOT.joinpath(*pkg.split(".")) / "__init__.py").exists(), pkg
        for mod in ROOT.joinpath(*pkg.split(".")).glob("*.py"):
            imported |= set(_imported_port_packages(mod))
    assert imported and imported <= port, sorted(imported - port)


def test_console_script_resolves():
    meta = tomllib.loads((ROOT / "pyproject.toml").read_text())
    scripts = meta["project"]["scripts"]
    assert scripts["radiodsp-sdr-rx"] == "radiodsp_sdr_rx_tpu.cli:main"
    target = scripts["radiodsp-sdr-rx-torch"]
    assert target == "radiodsp_sdr_rx_tpu_torch.cli:main"
    module, _, attr = target.partition(":")
    assert callable(getattr(importlib.import_module(module), attr))
    assert importlib.import_module(module).main is main
