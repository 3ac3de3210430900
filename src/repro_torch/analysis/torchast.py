"""PyTorch-aware AST helpers shared by the port's repro-lint passes
(counterpart of ``repro/analysis/jaxast.py``).

The central approximation is *capture-reachability*: a per-module fixpoint
over which function definitions can run while a CUDA graph is being
captured. Entry points are the callables that reach a ``with
torch.cuda.graph(...)`` block (called inside it, or handed to a parameter
that the block calls, through same-module calls, ``functools.partial`` and
lambdas), and the callables given to ``torch.cuda.make_graphed_callables``
or ``torch.compile`` (or decorated with the latter). The closure adds
nested ``def``s and same-module callees reached by bare-name or
``self.``-method calls. Like the reference's ``jit_reachable`` it is
module-local and errs toward over-approximation, the right direction for a
lint that feeds a baseline file.
"""
from __future__ import annotations

import ast
import dataclasses

# Dotted names that build a captured (or compiled) program: the
# constructors the retrace pass keeps out of loops.
CAPTURE_BUILDERS = {
    "torch.cuda.graph", "torch.cuda.CUDAGraph",
    "torch.cuda.make_graphed_callables", "torch.compile",
}
# The context managers whose body is captured into a CUDA graph.
CAPTURE_BLOCKS = {"torch.cuda.graph", "torch.cuda.graphs.graph"}
# Wrappers whose callable arguments (or decorated functions) are captured.
CAPTURE_WRAPPERS = {"torch.cuda.make_graphed_callables", "torch.compile"}

# The ``Draws`` protocol's consuming methods (``core/draws.py``): a key
# asked twice gives the same numbers. ``fold_in`` derives a child without
# consuming, as ``jax.random.fold_in`` does.
DRAW_METHODS = {"split", "normal", "uniform", "gumbel", "distinct_pair",
                "randint", "choice", "sgld"}
DRAW_DERIVE = {"split", "fold_in"}
# Draw-source constructors: a local bound to one is a fresh source.
DRAW_SOURCES = {"Draws", "KeyedDraws", "TorchDraws", "HostDraws"}


def _memo(tree: ast.AST, what: str, make):
    """``make()`` once per parsed module: the helpers every pass asks for
    (alias map, function list, capture reachability) keep their result on
    the tree itself."""
    slot = tree.__dict__.setdefault("_torchast_memo", {})
    if what not in slot:
        slot[what] = make()
    return slot[what]


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for Name/Attribute chains, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def alias_map(tree: ast.Module) -> dict[str, str]:
    """Local name -> canonical dotted path, from every import statement."""
    return _memo(tree, "aliases", lambda: _alias_map(tree))


def _alias_map(tree: ast.Module) -> dict[str, str]:
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            prefix = "." * node.level + mod
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = f"{prefix}.{a.name}"
    return out


def resolve(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """Canonical dotted path of a Name/Attribute, through import aliases."""
    name = dotted_name(node)
    if name is None:
        return None
    head, _, rest = name.partition(".")
    if head in aliases:
        name = aliases[head] + ("." + rest if rest else "")
    return name


def resolves_to(node: ast.AST, aliases: dict[str, str],
                targets: set[str]) -> str | None:
    """The target ``node`` names: exactly, or as a dotted tail of one
    (``cuda.graph`` after ``from torch import cuda``; a relative import's
    path without its leading dots). A bare name matches only exactly, so a
    local ``graph`` or the builtin ``compile`` is no ``torch`` call."""
    r = resolve(node, aliases)
    if r is None:
        return None
    if r in targets:
        return r
    tail = r.lstrip(".")
    if "." not in tail:
        return None
    for t in targets:
        if t.endswith("." + tail):
            return t
    return None


@dataclasses.dataclass
class FuncInfo:
    node: ast.FunctionDef | ast.AsyncFunctionDef | ast.Lambda
    qualname: str
    pos_params: list[str]       # positional (incl. pos-only) arg names
    kwonly: set[str]
    in_class: str | None        # enclosing class name, if a method


def collect_functions(tree: ast.Module) -> list[FuncInfo]:
    return _memo(tree, "functions", lambda: _collect_functions(tree))


def _collect_functions(tree: ast.Module) -> list[FuncInfo]:
    out: list[FuncInfo] = []

    def visit(node: ast.AST, stack: list[str], cls: str | None):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = ".".join(stack + [child.name])
                a = child.args
                pos = [p.arg for p in a.posonlyargs + a.args]
                out.append(FuncInfo(child, qn, pos,
                                    {p.arg for p in a.kwonlyargs}, cls))
                visit(child, stack + [child.name], cls)
            elif isinstance(child, ast.ClassDef):
                visit(child, stack + [child.name], child.name)
            else:
                visit(child, stack, cls)

    visit(tree, [], None)
    return out


def _callable_refs(node: ast.AST, aliases: dict[str, str]) -> list:
    """Local defs (by name) or lambdas (as nodes) an argument may bind."""
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, ast.Attribute):
        # self.method or module.fn: keep the final attribute for matching
        return [node.attr]
    if isinstance(node, ast.Lambda):
        return [node]
    if (isinstance(node, ast.Call) and node.args
            and resolves_to(node.func, aliases, {"functools.partial"})):
        return _callable_refs(node.args[0], aliases)
    return []


def _partial_base(node: ast.AST, aliases: dict[str, str]) -> ast.AST:
    """``f`` of ``functools.partial(f, ...)`` (repeatedly), else ``node``."""
    while (isinstance(node, ast.Call) and node.args
           and resolves_to(node.func, aliases, {"functools.partial"})):
        node = node.args[0]
    return node


def capture_blocks(tree: ast.Module, aliases: dict[str, str]) -> list:
    """Every ``with`` statement that captures a CUDA graph."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(it.context_expr, ast.Call)
                and resolves_to(it.context_expr.func, aliases,
                                CAPTURE_BLOCKS)
                for it in node.items):
            out.append(node)
    return out


def _has_capture(tree: ast.Module, aliases: dict[str, str]) -> bool:
    """Any capture block, capture-wrapper call or decorated def at all."""
    for n in ast.walk(tree):
        if isinstance(n, (ast.With, ast.AsyncWith)) and any(
                isinstance(it.context_expr, ast.Call)
                and resolves_to(it.context_expr.func, aliases,
                                CAPTURE_BLOCKS) for it in n.items):
            return True
        if (isinstance(n, ast.Call)
                and resolves_to(n.func, aliases, CAPTURE_WRAPPERS)):
            return True
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and any(
                resolves_to(d.func if isinstance(d, ast.Call) else d,
                            aliases, CAPTURE_WRAPPERS)
                for d in n.decorator_list):
            return True
    return False


def capture_reachable(tree: ast.Module,
                      aliases: dict[str, str]) -> dict[ast.AST, FuncInfo]:
    """Approximate the set of function defs that can run inside a CUDA
    graph capture."""
    return _memo(tree, "reachable",
                 lambda: _capture_reachable(tree, aliases))


def _capture_reachable(tree: ast.Module,
                       aliases: dict[str, str]) -> dict[ast.AST, FuncInfo]:
    if not _has_capture(tree, aliases):
        return {}
    funcs = collect_functions(tree)
    info = {f.node: f for f in funcs}
    by_name: dict[str, list[FuncInfo]] = {}
    for f in funcs:
        by_name.setdefault(f.node.name, []).append(f)

    # innermost enclosing def / lambda of every node
    owner: dict = {}

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            owner[child] = fn
            inner = child if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef,
                        ast.Lambda)) else fn
            visit(child, inner)
    visit(tree, None)

    def params(fn) -> list[str]:
        a = fn.args
        return [p.arg for p in a.posonlyargs + a.args]

    entries: set = set()             # defs and lambdas captured as callees
    sinks: set = set()               # (def node, param) the capture calls

    def add_refs(node):
        for ref in _callable_refs(node, aliases):
            if isinstance(ref, ast.Lambda):
                entries.add(ref)
            else:
                for f in by_name.get(ref, []):
                    entries.add(f.node)

    def param_of(node, fn) -> str | None:
        """The parameter of ``fn`` that ``node`` is (or a local bound to
        it or to a partial of it), else None."""
        if fn is None or isinstance(fn, ast.Lambda):
            return None
        node = _partial_base(node, aliases)
        if not isinstance(node, ast.Name):
            return None
        if node.id in params(fn):
            return node.id
        for st in ast.walk(fn):
            if (isinstance(st, ast.Assign) and len(st.targets) == 1
                    and isinstance(st.targets[0], ast.Name)
                    and st.targets[0].id == node.id):
                base = _partial_base(st.value, aliases)
                if isinstance(base, ast.Name) and base.id in params(fn):
                    return base.id
        return None

    def local_partial_refs(node, fn):
        """Local names bound to a partial of a local def: its refs."""
        if fn is None or not isinstance(node, ast.Name):
            return
        for st in ast.walk(fn):
            if (isinstance(st, ast.Assign) and len(st.targets) == 1
                    and isinstance(st.targets[0], ast.Name)
                    and st.targets[0].id == node.id
                    and isinstance(st.value, (ast.Call, ast.Lambda))):
                add_refs(st.value)

    # 1. decorated with / passed to a capture wrapper
    for f in funcs:
        for dec in f.node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if resolves_to(target, aliases, CAPTURE_WRAPPERS):
                entries.add(f.node)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and resolves_to(node.func, aliases, CAPTURE_WRAPPERS)):
            for op in list(node.args) + [kw.value for kw in node.keywords]:
                add_refs(op)
                p = param_of(op, owner.get(node))
                if p is not None:
                    sinks.add((owner[node], p))

    # 2. called inside a capture block: local defs are entries, the
    # enclosing function's parameters are sinks
    for blk in capture_blocks(tree, aliases):
        fn = owner.get(blk)
        for st in blk.body:
            for node in ast.walk(st):
                if not isinstance(node, ast.Call):
                    continue
                p = param_of(node.func, fn)
                if p is not None:
                    sinks.add((fn, p))
                elif isinstance(node.func, ast.Name):
                    add_refs(node.func)
                elif (isinstance(node.func, ast.Attribute)
                      and isinstance(node.func.value, ast.Name)
                      and node.func.value.id == "self"):
                    add_refs(node.func)
                if isinstance(node.func, ast.Name):
                    local_partial_refs(node.func, fn)

    # 3. callables handed to a sink parameter, through same-module calls
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)]
    changed = True
    while changed:
        changed = False
        sink_names = {}
        for fn, p in sinks:
            sink_names.setdefault(fn.name, []).append((fn, p))
        for call in calls:
            if isinstance(call.func, ast.Name):
                name, via_self = call.func.id, False
            elif (isinstance(call.func, ast.Attribute)
                  and isinstance(call.func.value, ast.Name)
                  and call.func.value.id == "self"):
                name, via_self = call.func.attr, True
            else:
                continue
            for fn, p in sink_names.get(name, []):
                ps = params(fn)
                if via_self and ps and ps[0] == "self":
                    ps = ps[1:]
                args = [a for i, a in enumerate(call.args)
                        if i < len(ps) and ps[i] == p]
                args += [kw.value for kw in call.keywords if kw.arg == p]
                caller = owner.get(call)
                for a in args:
                    add_refs(a)
                    local_partial_refs(a, caller)
                    q = param_of(a, caller)
                    if q is not None and (caller, q) not in sinks:
                        sinks.add((caller, q))
                        changed = True

    # 4. closure: nested defs and same-module callees (lambda bodies too)
    reachable = set(entries)
    frontier = list(reachable)
    while frontier:
        fn = frontier.pop()
        for node in ast.walk(fn):
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node is not fn and node in info):
                cands = [node]
            elif isinstance(node, ast.Call):
                name = None
                if isinstance(node.func, ast.Name):
                    name = node.func.id
                elif (isinstance(node.func, ast.Attribute)
                      and isinstance(node.func.value, ast.Name)
                      and node.func.value.id == "self"):
                    name = node.func.attr
                cands = [f.node for f in by_name.get(name, [])] \
                    if name else []
            else:
                continue
            for c in cands:
                if c not in reachable:
                    reachable.add(c)
                    frontier.append(c)
    return {n: info[n] for n in reachable if n in info}


def module_int_constants(tree: ast.Module) -> dict[str, int]:
    """Top-level ``NAME = <int literal>`` assignments."""
    out: dict[str, int] = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, int)
                and not isinstance(node.value.value, bool)):
            out[node.targets[0].id] = node.value.value
    return out


def contains_call(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) for n in ast.walk(node))
