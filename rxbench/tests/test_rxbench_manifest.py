"""BENCHMARK.json against the benchmark's contract, and every cell's files."""

import json
import re
from pathlib import Path

import pytest

from rxbench import harness

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["rxbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT.parent / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert all(1 <= len(w) <= 200 and "\n" not in w for w in BENCH["command"])


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_plain(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES_E2E and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert m["name"].split(".")[0].endswith("_roofline_pct") <= (m["unit"] == "%")


def reports(cell: str, metric: dict) -> bool:
    return cell in metric.get("workloads", [cell])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_per_layer_metrics_cells_report_what_it_moves(metric):
    m = {x["name"]: x for x in BENCH["per_layer"]}[metric]
    moved = {x["name"]: x for x in BENCH["end_to_end"]}[m["moves"]]
    cells = [w["name"] for w in BENCH["workloads"]]
    assert m["workloads"], metric
    for cell in m["workloads"]:
        assert cell in cells and reports(cell, moved), (metric, cell)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_has_its_files_and_metrics(cell):
    w = {x["name"]: x for x in BENCH["workloads"]}[cell]
    assert w["chips"] == 1 and len(w["why"]) <= 200
    cfg_entry = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    settings = json.loads((ROOT.parent / cfg_entry["file"]).read_text())
    assert cfg_entry["reduced"] == settings["reduced"] == []
    traffic = json.loads((ROOT / "traffic" / f"{w['traffic']}.json").read_text())
    for path in (ROOT / "generators" / f"{traffic['generator']}.py", ROOT / "cells" / f"{cell}.json",
                 ROOT / "work" / f"{w['config']}.json",
                 ROOT / "entries" / f"{settings['entry']}.py",
                 ROOT / "reference" / f"{settings['reference']}.py"):
        assert path.is_file(), path
    e2e = [m["name"] for m in BENCH["end_to_end"] if reports(cell, m)]
    layer = [m["name"] for m in BENCH["per_layer"] if reports(cell, m)]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for name in e2e + layer:
        assert harness.reader_path(name).is_file(), name
    limits = json.loads((ROOT / "cells" / f"{cell}.json").read_text())["limits"]
    assert set(limits) == set(settings["compare"]) and limits
    for number in settings["compare"].values():
        assert number["how"] in ("joint", "each", "exact")
        assert number.get("outputs", []) + number.get("state", [])


def test_a_metric_with_a_dot_falls_back_to_the_reader_of_its_stem():
    assert harness.reader_path("device_idle_pct.live") == ROOT / "metrics" / "device_idle_pct.py"
    assert harness.reader_path("setup_s") == ROOT / "metrics" / "setup_s.py"


def test_configs_are_used_and_files_distinct():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files) and all(f.startswith("rxbench/") for f in files)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
