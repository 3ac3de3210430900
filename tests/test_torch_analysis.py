"""The port's repro-lint (``src/repro_torch/analysis``) against the
reference's (``src/repro/analysis``), on the CPU.

* Engine and CLI parity: the same files, baseline entries and argv shapes
  give the same findings, ``format()`` strings, baseline splits, errors,
  exit codes and ``--json`` keys.
* Pass parity where a rule carries over: the port's protocol half and
  partition pass report exactly the reference's ``(line, rule)`` set on
  the reference's own fixtures (read, never modified).
* ``assert_flat`` parity: the reference's cases pass or raise alike, with
  the same messages.
* The port's fixture corpus (``tests/torch_analysis_fixtures``): every
  pass reports exactly its ``# PLANT:`` markers, clean twins silent.
* Capture reachability on the real streaming service, the repairs the lint
  drove there, and the repo gate: ``python -m repro_torch.analysis
  --fail-on-new`` is clean over ``src/repro_torch`` with no stale baseline
  entry, every entry a control-plane read the service's docstring names.
"""
import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro.analysis import engine as ref_engine
from repro.analysis import retrace as ref_retrace
from repro.analysis.__main__ import main as ref_main
from repro.analysis.passes import REGISTRY as REF_REGISTRY
from repro_torch.analysis import engine, retrace, torchast
from repro_torch.analysis.__main__ import main as port_main
from repro_torch.analysis.passes import REGISTRY, retrace_hazard

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
FIXDIR = HERE / "torch_analysis_fixtures"
REF_FIXDIR = HERE / "analysis_fixtures"
SERVICE = REPO / "src" / "repro_torch" / "serving" / "router_service.py"

PASS_FIXTURES = {
    "trace-hazard": ["fx_trace_hazard.py", "serving/fx_serving.py"],
    "prng-hygiene": ["fx_prng.py"],
    "retrace-hazard": ["fx_retrace.py"],
    "partition-coverage": ["fx_partition.py"],
    "protocol-kernel": ["fx_protocol.py", "kernels/fx_kernel.py"],
}


def _planted(fixdir: pathlib.Path, rel: str) -> set:
    """(rel, line, rule) triples from the ``# PLANT:`` markers."""
    out = set()
    for i, line in enumerate((fixdir / rel).read_text().splitlines(), 1):
        if "# PLANT:" in line:
            for rule in line.split("# PLANT:", 1)[1].split():
                out.add((rel, i, rule))
    return out


def _run(eng, registry, fixdir, files, name):
    ctx = eng.load_modules([fixdir / f for f in files], root=fixdir)
    fns = [(n, f) for n, f in registry if n == name]
    assert fns, f"unknown pass {name}"
    return eng.run_passes(ctx, fns)


def _rows(findings) -> list:
    return [dataclasses.astuple(f) for f in findings]


# ---------------------------------------------------------------------------
# (a) engine parity
# ---------------------------------------------------------------------------

def test_engine_matches_reference_on_the_same_files(tmp_path):
    for f in ("fx_partition.py", "fx_protocol.py"):
        (tmp_path / f).write_text((REF_FIXDIR / f).read_text())
    (tmp_path / "broken.py").write_text("def f(:\n")
    (tmp_path / "__pycache__").mkdir()
    (tmp_path / "__pycache__" / "skipped.py").write_text("x = 1\n")
    files = [tmp_path]
    ref_ctx = ref_engine.load_modules(files, tmp_path)
    ctx = engine.load_modules(files, tmp_path)
    assert [(m.rel, m.qualname) for m in ctx.modules] == \
        [(m.rel, m.qualname) for m in ref_ctx.modules]
    for name in ("partition-coverage", "protocol-kernel"):
        ref = ref_engine.run_passes(
            ref_ctx, [(n, f) for n, f in REF_REGISTRY if n == name])
        got = engine.run_passes(
            ctx, [(n, f) for n, f in REGISTRY if n == name])
        assert _rows(got) == _rows(ref), name
        assert [f.format() for f in got] == [f.format() for f in ref]
        assert [f.to_json() for f in got] == [f.to_json() for f in ref]
    syntax = [f for f in got if f.rule == "engine/syntax-error"]
    assert [(f.path, f.line) for f in syntax] == [("broken.py", 1)]


def test_baseline_loading_and_split_match_reference(tmp_path):
    entries = [
        {"rule": "prng/key-reuse", "path": "src/x.py", "reason": "ok"},
        {"rule": "prng/key-reuse", "path": "src/x.py", "symbol": "S.other",
         "reason": "other symbol"},
        {"rule": "trace-hazard/host-sync", "path": "src/x.py",
         "contains": ".cpu()", "reason": "by message"},
        {"rule": "trace-hazard/host-sync", "path": "src/y.py",
         "reason": "matches nothing"},
    ]
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps(entries))
    assert engine.load_baseline(p) == ref_engine.load_baseline(p) == entries
    assert engine.load_baseline(tmp_path / "none.json") == \
        ref_engine.load_baseline(tmp_path / "none.json") == []
    rows = [("src/x.py", 3, "prng/key-reuse", "S.step", "key `k`"),
            ("src/x.py", 9, "trace-hazard/host-sync", "S.f",
             ".cpu() forces a host sync"),
            ("src/x.py", 12, "trace-hazard/host-sync", "S.g", ".item()")]
    got = engine.split_against_baseline(
        [engine.Finding(*r) for r in rows], entries)
    ref = ref_engine.split_against_baseline(
        [ref_engine.Finding(*r) for r in rows], entries)
    assert [_rows(got[0]), _rows(got[1]), got[2]] == \
        [_rows(ref[0]), _rows(ref[1]), ref[2]]
    assert _rows(got[0]) == [rows[2]] and got[2] == entries[1:2] + \
        entries[3:]

    for bad in ([{"rule": "r", "path": "p"}], {"rule": "r"}):
        p.write_text(json.dumps(bad))
        msgs = []
        for load in (engine.load_baseline, ref_engine.load_baseline):
            with pytest.raises(ValueError) as e:
                load(p)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert "reason" in msgs[0] or "JSON list" in msgs[0]


# ---------------------------------------------------------------------------
# (b) CLI parity
# ---------------------------------------------------------------------------

def _cli_cases(tmp_path):
    clean = tmp_path / "clean.py"
    clean.write_text("def f(x):\n    return x + 1\n")
    part = str(REF_FIXDIR / "fx_partition.py")
    return {
        "clean": [str(clean), "--root", str(tmp_path), "--no-baseline",
                  "--fail-on-new"],
        "finding_reported": [part, "--root", str(REF_FIXDIR),
                             "--no-baseline", "--passes",
                             "partition-coverage"],
        "finding_fails": [part, "--root", str(REF_FIXDIR), "--no-baseline",
                          "--fail-on-new", "--passes",
                          "partition-coverage"],
        "unknown_pass": ["--root", str(tmp_path), "--passes", "nope"],
        "missing_path": [str(tmp_path / "definitely_not_here.py"),
                         "--root", str(tmp_path)],
    }


def test_cli_exit_codes_and_json_match_reference(tmp_path, capsys):
    want = dict(clean=0, finding_reported=0, finding_fails=1,
                unknown_pass=2, missing_path=2)
    for case, argv in _cli_cases(tmp_path).items():
        codes = []
        for main in (port_main, ref_main):
            codes.append(main(list(argv)))
            capsys.readouterr()
        assert codes == [want[case]] * 2, case
    argv = _cli_cases(tmp_path)["finding_reported"] + ["--json"]
    outs = []
    for main in (port_main, ref_main):
        assert main(list(argv)) == 0
        outs.append(json.loads(capsys.readouterr().out))
    assert set(outs[0]) == set(outs[1])
    assert outs[0] == outs[1]           # the partition pass carries over
    assert outs[0]["modules_scanned"] == 1


# ---------------------------------------------------------------------------
# (c) pass parity on the reference's fixtures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,fixture", [
    ("protocol-kernel", "fx_protocol.py"),
    ("partition-coverage", "fx_partition.py")])
def test_carried_over_rules_match_reference_fixtures(name, fixture):
    ref = {(f.line, f.rule)
           for f in _run(ref_engine, REF_REGISTRY, REF_FIXDIR, [fixture],
                         name)}
    got = {(f.line, f.rule)
           for f in _run(engine, REGISTRY, REF_FIXDIR, [fixture], name)}
    assert got == ref == {(line, rule) for _, line, rule
                          in _planted(REF_FIXDIR, fixture)}


# ---------------------------------------------------------------------------
# (d) assert_flat parity
# ---------------------------------------------------------------------------

class _Counter:
    """Stands in for RouterService.compiled_program_counts()."""

    def __init__(self):
        self.counts = {"captures": 1}

    def compiled_program_counts(self):
        return dict(self.counts)


def _flat_case(mod, case):
    """Run one of the reference's assert_flat cases with ``mod``; the
    outcome as (exception type name, message) or None."""
    c = _Counter()
    try:
        if case == "flat":
            with mod.assert_flat(c):
                pass
        elif case == "diff":
            with mod.assert_flat(c, note="hot path"):
                c.counts["captures"] += 1
        elif case == "midblock":
            with mod.assert_flat(c) as flat:
                flat.check("before")
                c.counts["s_route"] = 1
                try:
                    flat.check("after")
                finally:
                    del c.counts["s_route"]
        elif case == "exception_wins":
            with mod.assert_flat(c):
                c.counts["captures"] += 1
                raise RuntimeError("boom")
        elif case == "callable":
            counts = {"p": 3}
            with mod.assert_flat(lambda: counts):
                counts["p"] = 4
        elif case == "no_target":
            mod.assert_flat()
        elif case == "bad_target":
            mod.assert_flat(object()).__enter__()
        elif case == "check_outside":
            mod.assert_flat(c).check()
    except BaseException as e:     # the outcome is what is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", ["flat", "diff", "midblock",
                                  "exception_wins", "callable", "no_target",
                                  "bad_target", "check_outside"])
def test_assert_flat_matches_reference(case):
    got, ref = _flat_case(retrace, case), _flat_case(ref_retrace, case)
    assert got == ref
    want = dict(flat=None, exception_wins=("RuntimeError", "boom"))
    if case in want:
        assert got == want[case]
    elif case == "diff":
        assert got[0] == "AssertionError"
        assert "captures: 1 -> 2 (+1)" in got[1] and "[hot path]" in got[1]
    elif case == "midblock":
        assert got[0] == "AssertionError" and "s_route: 0 -> 1" in got[1]
    else:
        assert got is not None


# ---------------------------------------------------------------------------
# (e) the port's fixture corpus: planted bugs reported, clean twins silent
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pass_name", sorted(PASS_FIXTURES))
def test_fixture_findings_match_plants_exactly(pass_name):
    files = PASS_FIXTURES[pass_name]
    want = set()
    for f in files:
        want |= _planted(FIXDIR, f)
    assert want, f"fixtures for {pass_name} plant nothing"
    got = {(f.path, f.line, f.rule)
           for f in _run(engine, REGISTRY, FIXDIR, files, pass_name)}
    assert got == want, (
        f"{pass_name}: spurious={sorted(got - want)} "
        f"missed={sorted(want - got)}")


@pytest.mark.parametrize("pass_name", sorted(PASS_FIXTURES))
def test_cli_fail_on_new_trips_on_every_fixture(pass_name, capsys):
    files = [str(FIXDIR / f) for f in PASS_FIXTURES[pass_name]]
    rc = port_main(files + ["--root", str(FIXDIR), "--no-baseline",
                            "--fail-on-new", "--passes", pass_name])
    capsys.readouterr()
    assert rc == 1, pass_name


def test_fixture_directory_is_skipped_by_repo_runs():
    assert "torch_analysis_fixtures" in engine.SKIP_DIRS
    ctx = engine.load_modules([HERE], REPO)
    assert not any("torch_analysis_fixtures" in m.rel for m in ctx.modules)


# ---------------------------------------------------------------------------
# (f) reachability on the real service, and the repairs it drove there
# ---------------------------------------------------------------------------

def _service_tree():
    tree = ast.parse(SERVICE.read_text())
    return tree, torchast.alias_map(tree)


def test_capture_reachable_finds_the_stream_bodies():
    tree, aliases = _service_tree()
    names = {f.node.name for f in
             torchast.capture_reachable(tree, aliases).values()}
    assert {"route", "fold", "feedback", "resolve",
            "resolve_only"} <= names
    # the control plane and the tick-batch surface are not captured
    assert not names & {"route_batch", "feedback_batch", "route_stream",
                        "feedback_stream", "service_stats", "_gather",
                        "_capture"}


def test_service_captured_code_reads_no_rebound_attribute():
    """The streaming programs read the traffic accumulators
    (``_n_folded``, ``_duel_cost``) through ``_live``; the tick-batch
    surface used to re-bind them (``self._n_folded = self._n_folded +
    n``), which the frozen-host-value rule flags in captured code. Every
    write now goes through ``_commit`` (in place on a streaming service),
    so no captured read meets a re-bound attribute."""
    tree, aliases = _service_tree()
    cls = next(n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)
               and n.name == "RouterService")
    varying = retrace_hazard._varying_attrs(cls)
    assert {"tick", "n_routed"} <= varying
    assert not varying & {"_n_folded", "_duel_cost", "_tick_dev"}
    reachable = torchast.capture_reachable(tree, aliases)
    reads = {n.attr for f in reachable.values() for n in ast.walk(f.node)
             if isinstance(n, ast.Attribute)
             and isinstance(n.value, ast.Name) and n.value.id == "self"}
    assert {"_n_folded", "_duel_cost", "_tick_dev"} <= reads
    assert not reads & varying
    ctx = engine.load_modules([SERVICE], REPO)
    got = engine.run_passes(ctx, [(n, f) for n, f in REGISTRY
                                  if n == "retrace-hazard"])
    assert got == []


# ---------------------------------------------------------------------------
# (g) the repo gate
# ---------------------------------------------------------------------------

SYNC_FREE = ("route_batch", "feedback_batch", "route_stream",
             "feedback_stream", "feedback_direct", "spend", "seed_replay")


def _control_plane_reads() -> set:
    """The control-plane reads the service's docstring names."""
    doc = ast.get_docstring(ast.parse(SERVICE.read_text()))
    part = doc.split("control-plane reads", 1)[1].split("say so", 1)[0]
    return {w.strip("`(),.") for w in part.split() if "`" in w}


def test_repo_gate_is_clean_with_a_reasoned_baseline():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--json",
         "--fail-on-new"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    out = json.loads(run.stdout)
    assert out["new"] == [], out["new"]
    assert out["stale_baseline_entries"] == []
    assert out["modules_scanned"] >= 80
    assert out["passes"] == [n for n, _ in REGISTRY] == \
        [n for n, _ in REF_REGISTRY]
    entries = engine.load_baseline(
        REPO / "src" / "repro_torch" / "analysis" / "baseline.json")
    assert entries and all(e["reason"] for e in entries)
    reads = _control_plane_reads()
    assert {"pending_count", "service_stats", "active_mask",
            "autopilot_status", "refresh_due"} <= reads
    for e in entries:
        assert e["path"] == "src/repro_torch/serving/router_service.py"
        method = e["symbol"].rsplit(".", 1)[-1]
        named = {r for r in reads if r in e["reason"]} | \
            ({method} & reads)
        assert named or "compaction" in e["reason"].lower(), e
        assert method not in SYNC_FREE, e
    # every suppressed finding is one of the entries' symbols
    assert {f["symbol"] for f in out["suppressed"]} == \
        {e["symbol"] for e in entries}
