"""A new family of cells is new files and new entries in BENCHMARK.json: no
file that is there changes. A copy of the benchmark gains a toy carrier
receiver with a phase-tracking carry of its own (its configuration, entry,
reference, generator, traffic, work count and cells), and its cells run on
the CPU through the unchanged harness: the sound one is correct, one whose
phase carry is stuck is not, and one whose configuration forgets a carry
of the reference stops with an error instead of leaving it out."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

GENERATOR = '''
import math
import torch


def make_capture(mix, settings, capture, seed, device, channels=None, samples=None):
    c = int(settings["channels"]) if channels is None else channels
    n = int(mix["capture_samples"]) if samples is None else samples
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + capture) & 0x7FFFFFFFFFFFFFFF)
    t = torch.arange(n, dtype=torch.float64, device=device) / float(settings["sample_rate"])
    f = float(mix["carrier_hz"]) * (1 + torch.arange(c, dtype=torch.float64, device=device))[:, None]
    env = 1.0 + float(mix["depth"]) * torch.sin(2 * math.pi * 3.0 * t)
    noise = [torch.randn(c, n, generator=gen, device=device) * float(mix["noise_sigma"])
             for _ in range(2)]
    return ((env * torch.cos(2 * math.pi * f * t)).float() + noise[0],
            (env * torch.sin(2 * math.pi * f * t)).float() + noise[1])
'''

ENTRY = '''
from typing import NamedTuple

import torch


class ToyState(NamedTuple):
    pll_phase: torch.Tensor
    pll_freq: torch.Tensor


class ToyBank:
    def __init__(self, settings, device):
        self.n_channels = int(settings["channels"])
        self.device = torch.device(device)
        self.stuck = bool(settings.get("stuck", False))

    def init_state(self):
        z = torch.zeros(self.n_channels, dtype=torch.float64, device=self.device)
        return ToyState(z, z.clone())

    def process_planar(self, xr, xi, state):
        ang = torch.atan2(xi.to(self.device).double(), xr.to(self.device).double())
        step = torch.remainder(torch.diff(ang, dim=1, prepend=ang[:, :1]) + torch.pi,
                               2 * torch.pi) - torch.pi
        phase = state.pll_phase[:, None] + torch.cumsum(step, dim=1)
        audio = (torch.hypot(xr.double(), xi.double()) * torch.cos(phase)).float()
        new = ToyState(torch.remainder(phase[:, -1], 2 * torch.pi), step.mean(dim=1))
        return {"audio": audio}, (state if self.stuck else new)


def make(settings, device):
    return ToyBank(settings, device)


def state_view(bank, state):
    return state._asdict()
'''

REFERENCE = '''
import numpy as np
import torch


class ToyRef:
    def __init__(self, settings, device):
        self.c = int(settings["channels"])
        self.device = torch.device(device)

    def init_state(self):
        return {k: torch.zeros(self.c, dtype=torch.float64, device=self.device)
                for k in ("pll_phase", "pll_freq", "scratch")}

    def process(self, xr, xi, state):
        state = {k: v.cpu().numpy() for k, v in state.items()}
        xr, xi = xr.cpu().double().numpy(), xi.cpu().double().numpy()
        ang = np.arctan2(xi, xr)
        step = np.diff(ang, axis=1, prepend=ang[:, :1])
        step = np.remainder(step + np.pi, 2 * np.pi) - np.pi
        phase = state["pll_phase"][:, None] + np.cumsum(step, axis=1)
        audio = np.hypot(xr, xi) * np.cos(phase)
        new = {"pll_phase": np.remainder(phase[:, -1], 2 * np.pi), "pll_freq": step.mean(axis=1),
               "scratch": state["scratch"] + 1}
        as_t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        return {"audio": as_t(audio)}, {k: as_t(v) for k, v in new.items()}


def make(settings, device, tf32=False):
    return ToyRef(settings, device)
'''

READER = '''
def read(ctx):
    return ctx["calls"]
'''


def config(**extra):
    c = {"source": "a toy carrier receiver", "entry": "toy_pll", "reference": "toy_pll_ref",
         "channels": 3, "sample_rate": 8000.0, "reduced": [],
         "compare": {"audio": {"how": "joint", "outputs": ["audio"]},
                     "pll": {"how": "each", "state": ["pll_phase", "pll_freq"]}},
         "reference_own": {"scratch": "the reference's count of calls"}}
    c.update(extra)
    return c


NEW_FILES = {
    "generators/am_carrier.py": GENERATOR,
    "entries/toy_pll.py": ENTRY,
    "reference/toy_pll_ref.py": REFERENCE,
    "metrics/calls_done.py": READER,
    "configs/toy.json": json.dumps(config()),
    "configs/toy_stuck.json": json.dumps(config(stuck=True)),
    "configs/toy_silent.json": json.dumps(config(reference_own={})),
    "traffic/carrier.json": json.dumps({
        "generator": "am_carrier", "loop": "device_segments", "capture_samples": 2048,
        "span": 512, "captures": 2, "in_flight": 2, "carrier_hz": 400.0, "depth": 0.5,
        "noise_sigma": 0.01}),
    "work/toy.json": json.dumps({"block": 128, "fft_points": 2, "ffts_per_block": 0,
                                 "mask_products_per_block": 0,
                                 "flops_per_sample": {"toy": 10},
                                 "bytes_per_sample": {"toy": 12}}),
}
for _cfg in ("toy", "toy_stuck", "toy_silent"):
    NEW_FILES[f"work/{_cfg}.json"] = NEW_FILES["work/toy.json"]
    NEW_FILES[f"cells/{_cfg}.carrier.json"] = json.dumps({"limits": {"audio": 1e-4, "pll": 1e-4}})


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    """A copy of the benchmark with the toy family added as new files and
    new entries in its BENCHMARK.json."""
    top = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT, top / "rxbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for rel, text in NEW_FILES.items():
        path = top / "rxbench" / rel
        assert not path.exists(), rel
        path.write_text(text)
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    for cfg in ("toy", "toy_stuck", "toy_silent"):
        bench["configs"].append({"name": cfg, "source": "a toy", "file": f"rxbench/configs/{cfg}.json",
                                 "reduced": [], "why": "a toy"})
        bench["workloads"].append({"name": f"{cfg}.carrier", "config": cfg, "traffic": "carrier",
                                   "chips": 1, "why": "a toy"})
    bench["end_to_end"].append({"name": "calls_done", "unit": "calls", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["toy.carrier", "toy_stuck.carrier",
                                              "toy_silent.carrier"]})
    (top / "BENCHMARK.json").write_text(json.dumps(bench))
    return top


def run_in(top, cell):
    code = ("import json; from rxbench import harness; "
            f"print(json.dumps(harness.run_cell({cell!r}, 2**31 + 3, 0.2, False, device='cpu')))")
    return subprocess.run([sys.executable, "-c", code], cwd=top, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=str(top)))


def test_no_file_that_was_there_changes(copy):
    for path in ROOT.rglob("*"):
        rel = path.relative_to(ROOT)
        if path.is_file() and "tests" not in rel.parts and "__pycache__" not in rel.parts:
            assert (copy / "rxbench" / rel).read_bytes() == path.read_bytes(), rel


def test_the_new_family_runs_and_is_correct(copy):
    done = run_in(copy, "toy.carrier")
    assert done.returncode == 0, done.stderr[-3000:]
    r = json.loads(done.stdout.strip().splitlines()[-1])
    assert r["correct"] and set(r["checks"]) == {"audio", "pll"}
    assert set(r["metrics"]) == {"setup_s", "calls_done"}


def test_its_stuck_phase_carry_is_not_correct(copy):
    done = run_in(copy, "toy_stuck.carrier")
    assert done.returncode == 0, done.stderr[-3000:]
    r = json.loads(done.stdout.strip().splitlines()[-1])
    assert not r["correct"] and r["checks"]["pll"]["value"] > r["checks"]["pll"]["limit"]


def test_a_carry_the_configuration_forgets_stops_the_run(copy):
    done = run_in(copy, "toy_silent.carrier")
    assert done.returncode != 0 and "scratch" in done.stderr
