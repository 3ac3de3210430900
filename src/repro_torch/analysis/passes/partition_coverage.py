"""Pass 4 — partition-spec coverage for state-carrying tensor records
(counterpart of ``repro/analysis/passes/partition_coverage.py``, the same
rules and messages).

The sharding contract (ROADMAP "standing architecture") centralizes every
partition spec in ``sharding/routing_rules.py``, whose stand-in ``P``
spells the specs the reference's ``PartitionSpec`` does.  The failure mode this
pass exists for: a field grows on a NamedTuple that rides policy/serving
state (often with a ``None`` default, so nothing crashes), while the spec
constructor in routing_rules silently keeps sharding the *old* record —
the new field gets replicated or mis-partitioned under the mesh.

Detection: every class defined in the scanned tree whose bases mention
``NamedTuple`` is indexed with its ordered field list.  Any *spec-shaped*
constructor call of such a class — all-keyword, every value built from
``P(...)`` / ``PartitionSpec(...)`` (by bare name, as the reference
recognises them; ``None`` allowed as an explicit
"replicate" marker) — must name **every** field of the class:

* ``partition/missing-field``  a class field absent from the call;
* ``partition/unknown-field``  a keyword that matches no class field
  (classic rename drift).

Ordinary data constructions of the same classes (positional args, array
values) are not spec-shaped and are ignored.
"""
from __future__ import annotations

import ast
from typing import Iterable

from ..engine import AnalysisContext, Finding
from ..torchast import dotted_name

R_MISSING = "partition/missing-field"
R_UNKNOWN = "partition/unknown-field"

SPEC_NAMES = {"P", "PartitionSpec", "NamedSharding"}


def _namedtuple_fields(
        ctx: AnalysisContext) -> dict[str, tuple[str, list[str]]]:
    """class name -> (defining module rel path, ordered field names)."""
    out: dict[str, tuple[str, list[str]]] = {}
    for mod in ctx.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            base_names = {dotted_name(b) or "" for b in node.bases}
            if not any(b.split(".")[-1] == "NamedTuple" for b in base_names):
                continue
            fields = [st.target.id for st in node.body
                      if isinstance(st, ast.AnnAssign)
                      and isinstance(st.target, ast.Name)]
            if fields:
                out[node.name] = (mod.rel, fields)
    return out


def _is_spec_value(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and node.value is None:
        return True   # explicit "replicated" marker
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        return bool(name) and name.split(".")[-1] in SPEC_NAMES
    if isinstance(node, ast.Name):
        # a P(...) bound to a local (e.g. batch_axis spec reused per field)
        return node.id.islower() and len(node.id) <= 12
    return False


def run(ctx: AnalysisContext) -> Iterable[Finding]:
    classes = _namedtuple_fields(ctx)
    out: list[Finding] = []
    for mod in ctx.modules:
        # enclosing function qualname for nicer symbols (built on the
        # module's first spec-shaped call)
        func_of: dict[ast.AST, str] | None = None
        for call in ast.walk(mod.tree):
            if not isinstance(call, ast.Call):
                continue
            name = dotted_name(call.func)
            cls = name.split(".")[-1] if name else None
            if cls not in classes:
                continue
            if call.args or not call.keywords:
                continue        # positional/data construction, not a spec map
            if any(kw.arg is None for kw in call.keywords):
                continue        # **kwargs — can't check statically
            # spec-shaped = at least one literal P(...) value anchors the
            # call, and nothing looks like array data
            anchored = any(
                isinstance(kw.value, ast.Call)
                and (dotted_name(kw.value.func) or "").split(".")[-1]
                in SPEC_NAMES
                for kw in call.keywords)
            if not anchored:
                continue        # ordinary data construction
            if not all(_is_spec_value(kw.value) for kw in call.keywords):
                continue        # mixed call — not a pure spec map
            _def_mod, fields = classes[cls]
            given = [kw.arg for kw in call.keywords]
            if func_of is None:
                func_of = {}
                for fn in ast.walk(mod.tree):
                    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        for sub in ast.walk(fn):
                            func_of.setdefault(sub, fn.name)
            symbol = func_of.get(call, "")
            for f in fields:
                if f not in given:
                    out.append(Finding(
                        mod.rel, call.lineno, R_MISSING, symbol,
                        f"spec for {cls} misses field `{f}` — it will be "
                        "silently replicated/mis-sharded under the mesh; "
                        "add an explicit entry (None = replicate)"))
            for g in given:
                if g not in fields:
                    out.append(Finding(
                        mod.rel, call.lineno, R_UNKNOWN, symbol,
                        f"spec for {cls} names unknown field `{g}` — "
                        "stale after a rename?"))
    return out
