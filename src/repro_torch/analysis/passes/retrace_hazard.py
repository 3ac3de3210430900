"""Pass 3 — retrace-hazard: captured programs built per iteration, and
per-call host values frozen into a captured graph (counterpart of
``repro/analysis/passes/retrace_hazard.py``).

Two rules:

* ``retrace/capture-in-loop`` — constructing a captured or compiled
  program (``torch.cuda.graph`` / ``torch.cuda.CUDAGraph`` /
  ``torch.cuda.make_graphed_callables`` / ``torch.compile``) inside a
  Python ``for``/``while`` body. Each iteration captures (or compiles) a
  new program from scratch; nothing is reused. (Replaying a captured
  graph in a loop is fine; it's the *construction* in the loop that
  leaks.)

* ``retrace/frozen-host-value`` — inside a capture-reachable function, a
  read of an instance attribute that the class mutates per call (with
  ``+=`` or a self-referential reassignment, e.g. a tick counter). A
  captured graph replays the value (or the tensor object) it saw at
  capture forever: a host int is baked into the kernels' arguments, a
  re-bound tensor is left behind at its old address. The sanctioned form
  is a device tensor written in place, like the streaming service's
  device tick (``_tick_dev``, advanced by ``_commit``'s copy).
"""
from __future__ import annotations

import ast
from typing import Iterable

from ..engine import AnalysisContext, Finding
from ..torchast import (CAPTURE_BUILDERS, alias_map, capture_reachable,
                        resolves_to)

R_LOOP = "retrace/capture-in-loop"
R_FROZEN = "retrace/frozen-host-value"


def _captures_in_loops(mod, aliases) -> Iterable[Finding]:
    class V(ast.NodeVisitor):
        def __init__(self):
            self.loop_depth = 0
            self.findings: list[Finding] = []

        def visit_For(self, node):
            self._loop(node)

        def visit_AsyncFor(self, node):
            self._loop(node)

        def visit_While(self, node):
            self._loop(node)

        def _loop(self, node):
            self.loop_depth += 1
            self.generic_visit(node)
            self.loop_depth -= 1

        def visit_Call(self, node):
            if self.loop_depth > 0:
                hit = resolves_to(node.func, aliases, CAPTURE_BUILDERS)
                if hit:
                    self.findings.append(Finding(
                        mod.rel, node.lineno, R_LOOP, "",
                        f"{hit.rsplit('.', 1)[-1]}(...) constructed inside "
                        "a python loop — every iteration captures from "
                        "scratch; hoist the capture out of the loop"))
            self.generic_visit(node)

    v = V()
    v.visit(mod.tree)
    return v.findings


def _self_attr(node: ast.AST) -> str | None:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _varying_attrs(cls: ast.ClassDef) -> set[str]:
    """Attrs the class mutates per call: ``self.x += ...`` or
    ``self.x = <expr mentioning self.x>``."""
    varying: set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.AugAssign) and _self_attr(node.target):
            varying.add(node.target.attr)
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            attr = _self_attr(node.targets[0])
            if attr is None or isinstance(node.value, ast.Call):
                continue
            if any(_self_attr(ref) == attr for ref in ast.walk(node.value)):
                varying.add(attr)
    return varying


def _frozen_reads(mod, aliases) -> Iterable[Finding]:
    varying = {cls.name: _varying_attrs(cls) for cls in ast.walk(mod.tree)
               if isinstance(cls, ast.ClassDef)}
    reachable = capture_reachable(mod.tree, aliases)
    for fn in reachable.values():
        attrs = varying.get(fn.in_class or "", set())
        if not attrs:
            continue
        nested = {c for n in ast.walk(fn.node)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and n is not fn.node and n in reachable
                  for c in ast.walk(n) if c is not n}
        seen = set()
        for node in ast.walk(fn.node):
            if node in nested:
                continue          # nested defs are scanned as themselves
            attr = _self_attr(node)
            if attr in attrs and (node.lineno, attr) not in seen:
                seen.add((node.lineno, attr))
                yield Finding(
                    mod.rel, node.lineno, R_FROZEN, fn.qualname,
                    f"per-call-varying `self.{attr}` read in captured code "
                    "— the graph replays the value it saw at capture; keep "
                    "it in a device tensor written in place")


def run(ctx: AnalysisContext) -> Iterable[Finding]:
    out: list[Finding] = []
    for mod in ctx.modules:
        aliases = alias_map(mod.tree)
        out.extend(_captures_in_loops(mod, aliases))
        out.extend(_frozen_reads(mod, aliases))
    return out
