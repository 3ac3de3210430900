"""The command's contract where no card is: no result line and a non-zero
exit, in the checkout and in a directory that holds only the manifest and
the benchmark's folder; the manifest's per-cell files found by name."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import run  # noqa: E402

M = json.loads((ROOT / "BENCHMARK.json").read_text())


def _run(cwd: Path) -> subprocess.CompletedProcess:
    cell = M["workloads"][0]["name"]
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 11), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_bare_directory_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cell_files_found_by_name(cell):
    files = run.cell_files(cell)
    assert files["traffic"]["driver"] and files["limits"]
    assert {m["name"] for m in files["end_to_end"]} >= {"setup_s"}
    for m in files["per_layer"]:
        spec = run.metric_spec(m["name"])
        if spec["reader"] == "kernel_roofline":
            assert spec["patterns"]


def test_judge():
    assert run.judge({"a": 0.0, "b": 1.0}, {"a": 0.0, "b": 2.0})
    assert not run.judge({"a": 0.1}, {"a": 0.0})
    assert not run.judge({}, {"a": 1.0})
    assert not run.judge({"a": float("nan")}, {"a": 1.0})
