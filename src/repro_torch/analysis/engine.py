"""Core machinery of the port's repro-lint: findings, module loading,
baselines (counterpart of ``repro/analysis/engine.py``, the same behaviour
and messages).

A *pass* is a callable ``(AnalysisContext) -> Iterable[Finding]``.  The
engine parses every ``.py`` file under the requested roots once, hands the
shared context to each pass, and normalizes the output: findings are
deduplicated, sorted, and split against the committed suppression file
(``src/repro_torch/analysis/baseline.json``) so ``--fail-on-new`` only
trips on findings that are not already acknowledged with a reason.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
from typing import Callable, Iterable, Sequence

SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "analysis_fixtures",
             "torch_analysis_fixtures"}


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One diagnostic: ``path:line: [rule] symbol: message``."""

    path: str          # repo-relative, posix separators
    line: int
    rule: str          # e.g. "trace-hazard/host-sync"
    symbol: str        # enclosing function/class qualname ("" at module level)
    message: str

    def format(self) -> str:
        where = f"{self.symbol}: " if self.symbol else ""
        return f"{self.path}:{self.line}: [{self.rule}] {where}{self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Module:
    """A parsed source file plus the names passes key off."""

    path: pathlib.Path     # absolute
    rel: str               # repo-relative posix path (finding.path)
    qualname: str          # dotted module name, e.g. "repro_torch.kernels"
    tree: ast.Module
    source: str


@dataclasses.dataclass
class AnalysisContext:
    root: pathlib.Path
    modules: list[Module]

    def by_qualname(self, qualname: str) -> Module | None:
        for m in self.modules:
            if m.qualname == qualname:
                return m
        return None


def _qualname_for(rel: str) -> str:
    parts = pathlib.PurePosixPath(rel).with_suffix("").parts
    if parts and parts[0] == "src":
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def load_modules(paths: Sequence[pathlib.Path],
                 root: pathlib.Path) -> AnalysisContext:
    """Parse every .py under ``paths`` (files or directories)."""
    root = root.resolve()
    files: list[pathlib.Path] = []
    for p in paths:
        p = p.resolve()
        if p.is_dir():
            files.extend(sorted(
                f for f in p.rglob("*.py")
                if not any(part in SKIP_DIRS for part in f.parts)))
        elif p.suffix == ".py":
            files.append(p)
    modules = []
    for f in files:
        try:
            rel = f.relative_to(root).as_posix()
        except ValueError:
            rel = f.name
        source = f.read_text()
        try:
            tree = ast.parse(source, filename=str(f))
        except SyntaxError as e:   # surfaced as a finding, not a crash
            modules.append(Module(f, rel, _qualname_for(rel),
                                  ast.Module(body=[], type_ignores=[]),
                                  source))
            modules[-1].tree._repro_syntax_error = e  # type: ignore[attr-defined]
            continue
        modules.append(Module(f, rel, _qualname_for(rel), tree, source))
    return AnalysisContext(root=root, modules=modules)


def run_passes(ctx: AnalysisContext,
               passes: Iterable[tuple[str, Callable]]) -> list[Finding]:
    findings: set[Finding] = set()
    for m in ctx.modules:
        err = getattr(m.tree, "_repro_syntax_error", None)
        if err is not None:
            findings.add(Finding(m.rel, err.lineno or 1, "engine/syntax-error",
                                 "", f"file does not parse: {err.msg}"))
    for _name, fn in passes:
        findings.update(fn(ctx))
    return sorted(findings)


# ---------------------------------------------------------------------------
# Baseline suppression
# ---------------------------------------------------------------------------
#
# src/repro_torch/analysis/baseline.json holds a list of entries:
#   {"rule": ..., "path": ..., "symbol": ... (optional),
#    "contains": ... (optional substring of message), "reason": ...}
# "reason" is mandatory — a suppression without a why is a bug magnet.
# Lines are deliberately NOT part of the match key so routine edits above a
# baselined finding don't invalidate the entry.

def load_baseline(path: pathlib.Path) -> list[dict]:
    if not path.exists():
        return []
    entries = json.loads(path.read_text())
    if not isinstance(entries, list):
        raise ValueError(f"{path}: baseline must be a JSON list")
    for e in entries:
        for req in ("rule", "path", "reason"):
            if not e.get(req):
                raise ValueError(
                    f"{path}: baseline entry {e!r} missing required "
                    f"'{req}' field")
    return entries


def entry_matches(entry: dict, f: Finding) -> bool:
    if entry["rule"] != f.rule or entry["path"] != f.path:
        return False
    if entry.get("symbol") is not None and entry["symbol"] != f.symbol:
        return False
    if entry.get("contains") and entry["contains"] not in f.message:
        return False
    return True


def split_against_baseline(
        findings: Sequence[Finding], entries: Sequence[dict],
) -> tuple[list[Finding], list[Finding], list[dict]]:
    """Return (new, suppressed, unused_entries)."""
    used = [False] * len(entries)
    new, suppressed = [], []
    for f in findings:
        hit = False
        for i, e in enumerate(entries):
            if entry_matches(e, f):
                used[i] = True
                hit = True
        (suppressed if hit else new).append(f)
    unused = [e for i, e in enumerate(entries) if not used[i]]
    return new, suppressed, unused
