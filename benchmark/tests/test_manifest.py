"""BENCHMARK.json against the contract's shape and the files it names."""

import json
import re
from pathlib import Path

import pytest

from benchmark.harness.main import cell_files, cell_metrics, load_reader

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(MANIFEST) == TOP_KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"] and 1 <= MANIFEST["run_seconds"] <= 51


@pytest.mark.parametrize("part", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(part):
    names = [e["name"] for e in MANIFEST[part]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


def test_every_metric_has_a_well_formed_unit_and_direction():
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25


def test_cells_name_existing_configs_and_files():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    for w in MANIFEST["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        files = cell_files(w["name"])
        assert files["workload"]["config"] == w["config"] and files["workload"]["traffic"] == w["traffic"]
        assert files["config"]["name"] == w["config"]
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert c["name"] in used and (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]


def test_every_metrics_cells_exist_and_every_cell_reports_enough():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        moved = next(x for x in MANIFEST["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells)), m["name"]
    for cell in cells:
        got = cell_metrics(cell, MANIFEST)
        names = [n for n, _, _ in got["end_to_end"]]
        assert "setup_s" in names and len(names) >= 2 and got["per_layer"], cell


def test_metric_files_agree_with_the_manifest():
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        reader = load_reader(m["name"])
        assert reader.UNIT == m["unit"], m["name"]
        if "layer" in m:
            assert reader.LAYER == m["layer"] and reader.MOVES == m["moves"], m["name"]
