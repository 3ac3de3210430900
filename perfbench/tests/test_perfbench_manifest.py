"""The manifest and the files the harness finds by name."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in M["end_to_end"]}


def _reports(cell: str) -> set:
    return {m["name"] for m in M["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}


def test_top_level_keys_and_limits():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["perfbench"] and M["command"][1] == "perfbench/run.py"
    assert 1 <= M["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of the most cells later PRs may add fits its time
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", M["configs"] + M["workloads"]
                         + M["end_to_end"] + M["per_layer"],
                         ids=lambda e: e["name"])
def test_names_units_and_texts(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower",
                                                                 "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] \
                and "\t" not in entry[key]
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in M[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_bounds():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_its_cells_report(metric):
    assert metric["moves"] in E2E and metric["moves"] != "setup_s"
    assert metric["workloads"]
    for cell in metric["workloads"]:
        assert metric["moves"] in _reports(cell)
    spec = json.loads((BENCH / "metrics" / f"{metric['name']}.json")
                      .read_text())
    assert (BENCH / "readers" / f"{spec['reader']}.py").is_file()
    assert spec["layer"] == metric["layer"] and spec["moves"] == metric["moves"]
    if metric["name"].split(".")[0].endswith("_roofline") or "mfu" in \
            metric["name"]:
        assert metric["unit"] == "%"


def test_layers_named_alike():
    by_reader_layer = {}
    for m in M["per_layer"]:
        by_reader_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_reader_layer.values())


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda w: w["name"])
def test_cell_files_and_reports(cell):
    reports = _reports(cell["name"])
    assert "setup_s" in reports and len(reports) >= 2
    assert any(cell["name"] in m["workloads"] for m in M["per_layer"])
    assert cell["chips"] in (1, 4)
    tr = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                    .read_text())
    assert (BENCH / "drivers" / f"{tr['driver']}.py").is_file()
    limits = json.loads((BENCH / "workloads" / f"{cell['name']}.json")
                        .read_text())["limits"]
    assert limits and all(v >= 0 for v in limits.values())


def test_four_chip_cells_at_most_a_quarter():
    n4 = sum(w["chips"] == 4 for w in M["workloads"])
    assert n4 <= max(1, len(M["workloads"]) // 4)


@pytest.mark.parametrize("conf", M["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    path = ROOT / conf["file"]
    assert path.is_file() and conf["file"].startswith("perfbench/")
    data = json.loads(path.read_text())
    assert data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"] and len(conf["reduced"]) <= 16
    for key in conf["reduced"]:
        assert NAME.match(key) and key in data
        assert not (key.endswith("_dim") or key.endswith("_rank")
                    or "hidden" in key or "intermediate" in key)
    assert conf["name"] in {w["config"] for w in M["workloads"]}
