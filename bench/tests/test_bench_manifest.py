"""BENCHMARK.json against the benchmark's contract, and every file a
cell names found by name."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["bench"]
    assert MANIFEST["command"] == ["python3", "bench/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    n_cells = len(MANIFEST["workloads"])
    # a full check: 2 + 14 runs a cell, each run_seconds + 60 s, 180 s of
    # compile a cell and 1200 s spare, within 43,200 s at 24 cells
    assert (2 + 14 * 24) * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= n_cells <= 24


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[key]:
            yield key, entry


@pytest.mark.parametrize("key,entry", list(_names()), ids=lambda v: v if isinstance(v, str)
                         else v.get("name"))
def test_names_units_and_keys(key, entry):
    assert NAME.match(entry["name"]), entry["name"]
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
    }[key]
    assert set(entry) <= allowed
    for text in ("why", "layer", "source"):
        if text in entry:
            assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text]
            assert "\t" not in entry[text]
    if key in ("end_to_end", "per_layer"):
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        assert entry["source"] in SOURCES
    if key == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if key == "workloads":
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
        assert entry["chips"] == 1
    if key == "configs":
        assert all(NAME.match(k) for k in entry["reduced"])
        assert len(entry["reduced"]) <= 16


def test_names_are_unique_and_cells_resolve():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in MANIFEST[key]]
        assert len(names) == len(set(names))
    metrics = [e["name"] for e in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))
    configs = {c["name"] for c in MANIFEST["configs"]}
    assert {w["config"] for w in MANIFEST["workloads"]} == configs
    assert {(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}.__len__() == len(
        MANIFEST["workloads"])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_file_found_by_name(cell):
    from bench import harness

    c = harness.load_cell(ROOT, cell)
    assert (BENCH / "traffic" / f"{c.mix['generator']}.py").exists()
    assert c.limits, "every cell compares numbers with a limit"
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in e2e


@pytest.mark.parametrize("entry", MANIFEST["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    path = ROOT / entry["file"]
    assert path.parts[len(ROOT.parts)] == "bench"
    cfg = json.loads(path.read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    for key in entry["reduced"]:
        assert not key.endswith(("_dim", "_rank", "_size")), "a width is never cut"
        assert cfg[key] != cfg["published"][key]
    assert cfg["dtype"] == "float32" and cfg["tf32"] is False
    assert (BENCH / "models" / f"{cfg['family']}.py").is_file()
    assert (BENCH / "gen" / f"{cfg['graph_generator']}.py").is_file()
