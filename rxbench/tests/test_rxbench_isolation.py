"""Nothing the benchmark runs imports JAX or the JAX package, and its
reference imports nothing of the program either. Top-level module names
are compared whole: the port's name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "radiodsp_sdr_rx_tpu"}
PROGRAM = "radiodsp_sdr_rx_tpu_torch"


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(ROOT.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in imported(path)
    assert "rxbench" not in imported(path)


def test_the_whole_name_is_compared():
    from rxbench.run import FORBIDDEN as AT_RUN_TIME

    assert PROGRAM.split(".")[0] not in AT_RUN_TIME and "radiodsp_sdr_rx_tpu" in AT_RUN_TIME
