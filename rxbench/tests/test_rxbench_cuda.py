"""The command on the card and off it. On the card (``cuda`` marker, decided
inside the fixture): each cell runs 10 s from the checkout's root, correct,
with its metrics. Anywhere without a card: the command exits non-zero and
prints no result."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())


def command(cell, seed, trace):
    return [sys.executable, "-m", "rxbench.run", "--workload", cell, "--seed", str(seed),
            "--seconds", "10", "--trace", str(trace)]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the benchmark never falls back to the CPU")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_the_card(card, cell, trace):
    done = subprocess.run(command(cell, 2**31 + 7, trace), cwd=ROOT.parent,
                          capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-3000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in BENCH[kind] if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == want


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    done = subprocess.run(command("usb128.seg19", 1, 0), cwd=ROOT.parent,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout.strip() == ""
