"""The PyTorch port never imports JAX or the JAX package.

Walks the syntax tree of every module of ``radiodsp_sdr_rx_tpu_torch`` and of
``chip_smoke.py`` (which must run on a machine without JAX) and fails on any
import of ``jax``, ``jaxlib`` or ``radiodsp_sdr_rx_tpu``, at any depth.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "radiodsp_sdr_rx_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "radiodsp_sdr_rx_tpu"}


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_has_modules():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"chip_smoke.py", "radiodsp_sdr_rx_tpu_torch/ops/sweep.py",
            "radiodsp_sdr_rx_tpu_torch/ops/staged.py",
            "radiodsp_sdr_rx_tpu_torch/ops/chain_common.py",
            "radiodsp_sdr_rx_tpu_torch/ops/agc.py",
            "radiodsp_sdr_rx_tpu_torch/ops/iir.py",
            "radiodsp_sdr_rx_tpu_torch/ops/planar.py",
            "radiodsp_sdr_rx_tpu_torch/ops/qformat.py",
            "radiodsp_sdr_rx_tpu_torch/ops/lms.py",
            "radiodsp_sdr_rx_tpu_torch/ops/lms_bank.py",
            "radiodsp_sdr_rx_tpu_torch/ops/spectral_sub.py",
            "radiodsp_sdr_rx_tpu_torch/ops/sweep_spec.py",
            "radiodsp_sdr_rx_tpu_torch/ops/sam.py",
            "radiodsp_sdr_rx_tpu_torch/ops/sam_wide.py",
            "radiodsp_sdr_rx_tpu_torch/ops/preprocessor.py",
            "radiodsp_sdr_rx_tpu_torch/ops/noise_blanker.py",
            "radiodsp_sdr_rx_tpu_torch/ops/fastconv.py",
            "radiodsp_sdr_rx_tpu_torch/utils/siggen.py",
            "radiodsp_sdr_rx_tpu_torch/utils/scenes.py",
            "radiodsp_sdr_rx_tpu_torch/models/receiver.py",
            "radiodsp_sdr_rx_tpu_torch/models/fused.py",
            "radiodsp_sdr_rx_tpu_torch/version.py",
            "radiodsp_sdr_rx_tpu_torch/ops/analyzers.py",
            "radiodsp_sdr_rx_tpu_torch/ops/windows.py",
            "radiodsp_sdr_rx_tpu_torch/ops/decimate.py",
            "radiodsp_sdr_rx_tpu_torch/ops/channelizer.py",
            "radiodsp_sdr_rx_tpu_torch/models/metrics.py",
            "radiodsp_sdr_rx_tpu_torch/models/channelized.py",
            "radiodsp_sdr_rx_tpu_torch/utils/smeter.py",
            "radiodsp_sdr_rx_tpu_torch/utils/display.py",
            "radiodsp_sdr_rx_tpu_torch/utils/io.py",
            "radiodsp_sdr_rx_tpu_torch/utils/checkpoint.py",
            "radiodsp_sdr_rx_tpu_torch/utils/profiling.py",
            "radiodsp_sdr_rx_tpu_torch/utils/audio_sink.py",
            "radiodsp_sdr_rx_tpu_torch/utils/native_io.py",
            "radiodsp_sdr_rx_tpu_torch/models/streaming.py",
            "radiodsp_sdr_rx_tpu_torch/models/vfo.py",
            "radiodsp_sdr_rx_tpu_torch/models/controls.py",
            "radiodsp_sdr_rx_tpu_torch/models/appliance.py",
            "radiodsp_sdr_rx_tpu_torch/cli.py",
            "radiodsp_sdr_rx_tpu_torch/__main__.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_sees_forbidden_imports():
    src = "import jax.numpy\nfrom radiodsp_sdr_rx_tpu.ops import nco\n" \
          "def f():\n    import importlib; importlib.import_module('jax')\n"
    assert [m for m in _imported(ast.parse(src)) if m.split(".")[0] in FORBIDDEN] == \
        ["jax.numpy", "radiodsp_sdr_rx_tpu.ops", "jax"]
