"""Pass 2 — PRNG hygiene: linear use of draw sources (counterpart of
``repro/analysis/passes/prng.py``).

A draw source is the port's PRNG key: ``KeyedDraws`` gives the same
numbers for the same key however often it is asked (``core/draws.py``),
exactly as a JAX key does, so asking one source twice silently correlates
draws. The legitimate non-consuming reuse is ``src.fold_in(i)``, deriving
a per-step child from a base source.

Tracked sources: parameters named ``draws``, ``src`` or ``dr`` or
annotated ``Draws`` / ``KeyedDraws`` / ``TorchDraws`` / ``HostDraws``, and
locals assigned from those constructors or from ``.split(...)`` /
``.fold_in(...)`` of a source. Each *consuming* occurrence (a call of one
of the protocol's consuming methods on the name: ``split``, ``normal``,
``uniform``, ``gumbel``, ``randint``, ``choice``, ``distinct_pair``,
``sgld``; or the name handed to a call, which draws from it) bumps a use
counter; the second consumption of the same name without an intervening
re-assignment is flagged as ``prng/key-reuse``.

A ``torch.Generator`` local is a source whose key is its seed: its draws
(calls given ``generator=g``) advance it, so one seeding hands out fresh
numbers draw after draw; seeded again with the same seed expression (no
name of it re-bound in between) it hands the same numbers out again, and
its next draw is flagged the same way.

Control flow: ``if``/``else`` branches fork the counter state and merge
with max (a use on either branch counts). Loop bodies are processed
twice so a consumption that is fine once but repeats every iteration —
``for i in ...: src.normal(...)`` — trips on the second sweep. ``for sub
in src.split(n)`` re-binds ``sub`` fresh each iteration and stays clean.
"""
from __future__ import annotations

import ast
from typing import Iterable

from ..engine import AnalysisContext, Finding
from ..torchast import (DRAW_DERIVE, DRAW_METHODS, DRAW_SOURCES, alias_map,
                        collect_functions, dotted_name, resolves_to)

RULE = "prng/key-reuse"
DRAW_PARAM_NAMES = {"draws", "src", "dr"}
GENERATOR = {"torch.Generator"}
HOST_SCALARS = {"bool", "int", "float", "str"}
# calls that look at a source without drawing from it
INSPECTING = {"isinstance", "type", "id", "repr", "str", "print", "hasattr",
              "getattr"}
# a generator's entries in the counter state: "<g>\x00" marks a generator
# local, "<g>\x00<seed>" a seeding, "<g>\x00!" a repeated seeding
_SEP = "\x00"


def _terminates(stmts: list) -> bool:
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


def _is_source_ctor(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and (dotted_name(node.func) or "").split(".")[-1]
            in DRAW_SOURCES)


class _FuncScan:
    def __init__(self, mod, fn, aliases):
        self.mod = mod
        self.fn = fn
        self.aliases = aliases
        self.findings: list[Finding] = []
        self.emitted: set[tuple[str, int]] = set()

    def _flag(self, name: str, line: int, what: str):
        if (name, line) not in self.emitted:
            self.emitted.add((name, line))
            self.findings.append(Finding(
                self.mod.rel, line, RULE, self.fn.qualname, what))

    # -- which expressions are draw sources ---------------------------------

    def _source_like(self, node: ast.AST, state: dict[str, int]) -> bool:
        """A tracked name, a constructor, or a split / fold_in of one (or
        of the service's ``self._draws`` / ``self.src``)."""
        if isinstance(node, ast.Subscript):
            return self._source_like(node.value, state)
        if isinstance(node, ast.Name):
            return node.id in state
        if isinstance(node, ast.Attribute):
            return (isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and node.attr.lstrip("_") in DRAW_PARAM_NAMES)
        if _is_source_ctor(node):
            return True
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in DRAW_DERIVE
                and self._source_like(node.func.value, state))

    def _is_generator(self, node: ast.AST) -> tuple[bool, ast.AST | None]:
        """(``node`` builds a torch.Generator, its seed expression)."""
        seed = None
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr == "manual_seed" and node.args):
            seed, node = node.args[0], node.func.value
        ok = (isinstance(node, ast.Call)
              and resolves_to(node.func, self.aliases, GENERATOR)
              is not None)
        return ok, seed if ok else None

    # -- expression side: count consuming uses ------------------------------

    def _consume(self, name: str, line: int, state: dict[str, int]):
        if name not in state:
            return
        state[name] += 1
        if state[name] >= 2:
            self._flag(name, line,
                       f"draw source `{name}` consumed again without "
                       "split/fold_in — draws will be correlated")

    def _seed(self, gen: str, seed: ast.AST, line: int, state):
        """``gen`` (re)seeded with ``seed``."""
        mark = f"{gen}{_SEP}{ast.unparse(seed)}"
        if mark in state:
            state[f"{gen}{_SEP}!"] = line
        else:
            state[mark] = line
            state.pop(f"{gen}{_SEP}!", None)

    def _generator_draw(self, gen: str, line: int, state):
        if state.get(f"{gen}{_SEP}!"):
            self._flag(gen, line,
                       f"generator `{gen}` re-seeded with a seed it was "
                       "seeded with before — its draws repeat")

    def _uses(self, node: ast.AST, state: dict[str, int]):
        """Walk an expression, counting consuming source occurrences."""
        if isinstance(node, ast.Call):
            f = node.func
            recv = f.value if isinstance(f, ast.Attribute) else None
            if isinstance(recv, ast.Name) and recv.id in state:
                if f.attr == "fold_in":
                    pass                 # the blessed non-consuming reuse
                elif f.attr in DRAW_METHODS:
                    self._consume(recv.id, node.lineno, state)
            elif (isinstance(f, ast.Attribute) and f.attr == "manual_seed"
                  and isinstance(recv, ast.Name) and node.args
                  and f"{recv.id}{_SEP}" in state):
                self._seed(recv.id, node.args[0], node.lineno, state)
            elif recv is not None:
                self._uses(recv, state)
            if isinstance(f, ast.Name) and f.id in INSPECTING:
                return
            for child in node.args:
                self._arg(child, node.lineno, state)
            for kw in node.keywords:
                if (kw.arg == "generator" and isinstance(kw.value, ast.Name)
                        and f"{kw.value.id}{_SEP}" in state):
                    self._generator_draw(kw.value.id, node.lineno, state)
                else:
                    self._arg(kw.value, node.lineno, state)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return   # separate scope, scanned on its own
        for child in ast.iter_child_nodes(node):
            self._uses(child, state)

    def _arg(self, node: ast.AST, line: int, state: dict[str, int]):
        """A call argument: a bare tracked source handed over is drawn
        from by the callee."""
        if isinstance(node, ast.Name):
            self._consume(node.id, line, state)
        elif isinstance(node, ast.Starred):
            self._arg(node.value, line, state)
        else:
            self._uses(node, state)

    # -- statement side ------------------------------------------------------

    def _assign_targets(self, targets, fresh: bool, state):
        for t in targets:
            if isinstance(t, (ast.Tuple, ast.List)):
                self._assign_targets(t.elts, fresh, state)
            elif isinstance(t, ast.Starred):
                self._assign_targets([t.value], fresh, state)
            elif isinstance(t, ast.Name):
                if fresh:
                    state[t.id] = 0
                else:
                    state.pop(t.id, None)
                self._rebound(t.id, state)
            # Attribute/Subscript targets (self._draws = ...) are not
            # tracked: attribute lifetimes cross method boundaries.

    def _rebound(self, name: str, state):
        """``name`` re-bound: generator seedings that read it go stale, a
        generator named so is a new object."""
        for mark in [m for m in state if _SEP in m]:
            gen, _, seed = mark.partition(_SEP)
            if gen == name or (seed != "!" and name in {
                    n.id for n in ast.walk(ast.parse(seed))
                    if isinstance(n, ast.Name)}):
                state.pop(mark, None)

    def block(self, stmts, state: dict[str, int]):
        for st in stmts:
            self.stmt(st, state)

    def stmt(self, st: ast.stmt, state: dict[str, int]):
        if isinstance(st, ast.If):
            self._uses(st.test, state)
            s1, s2 = dict(state), dict(state)
            self.block(st.body, s1)
            self.block(st.orelse, s2)
            # A branch that leaves the function (early return/raise) never
            # reaches the fall-through code: its counts stay out of the
            # merge (uses *inside* it were already checked above).
            live = []
            if not _terminates(st.body):
                live.append(s1)
            if not _terminates(st.orelse):
                live.append(s2)
            if not live:
                live = [s2]    # both exit; fall-through is unreachable
            for n in set().union(*(set(s) for s in live)):
                state[n] = max(s.get(n, 0) for s in live)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            self._uses(st.iter, state)
            iter_is_split = (isinstance(st.iter, ast.Call)
                             and isinstance(st.iter.func, ast.Attribute)
                             and st.iter.func.attr == "split"
                             and self._source_like(st.iter.func.value,
                                                   state))
            for _sweep in range(2):
                # the loop target re-binds every iteration (a fresh child
                # when iterating a split, untracked otherwise)
                self._assign_targets(
                    [st.target], fresh=bool(iter_is_split), state=state)
                self.block(st.body, state)
            self.block(st.orelse, state)
        elif isinstance(st, ast.While):
            for _sweep in range(2):
                self._uses(st.test, state)
                self.block(st.body, state)
            self.block(st.orelse, state)
        elif isinstance(st, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = st.value
            if value is None:
                return
            targets = (st.targets if isinstance(st, ast.Assign)
                       else [st.target])
            fresh = self._source_like(value, state) and not isinstance(
                value, ast.Name)
            gen, seed = self._is_generator(value)
            self._uses(value, state)
            self._assign_targets(targets, fresh=fresh, state=state)
            if gen:
                for t in targets:
                    if isinstance(t, ast.Name):
                        state[f"{t.id}{_SEP}"] = 0
                        if seed is not None:
                            self._seed(t.id, seed, st.lineno, state)
        elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return   # nested scope scanned separately
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                self._uses(item.context_expr, state)
            self.block(st.body, state)
        elif isinstance(st, ast.Try):
            self.block(st.body, state)
            for h in st.handlers:
                self.block(h.body, state)
            self.block(st.orelse, state)
            self.block(st.finalbody, state)
        else:
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.expr):
                    self._uses(child, state)
                elif isinstance(child, ast.stmt):
                    self.stmt(child, state)


def _source_params(fn) -> list[str]:
    """Parameters named or annotated as a draw source (a name annotated
    as a host scalar, ``draws: bool``, is a flag)."""
    a = fn.node.args
    out = []
    for p in a.posonlyargs + a.args + a.kwonlyargs:
        ann = ast.unparse(p.annotation) if p.annotation is not None else ""
        words = {w.split(".")[-1] for w in ann.replace("|", " ").replace(
            "[", " ").replace("]", " ").replace('"', " ").split()}
        if words & DRAW_SOURCES or (p.arg in DRAW_PARAM_NAMES
                                    and not words & HOST_SCALARS):
            out.append(p.arg)
    return out


def run(ctx: AnalysisContext) -> Iterable[Finding]:
    out: list[Finding] = []
    for mod in ctx.modules:
        aliases = alias_map(mod.tree)
        for fn in collect_functions(mod.tree):
            scan = _FuncScan(mod, fn, aliases)
            state = {p: 0 for p in _source_params(fn)}
            scan.block(fn.node.body, state)
            out.extend(scan.findings)
    return out
