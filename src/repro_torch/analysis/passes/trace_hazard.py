"""Pass 1 — trace-hazard: host syncs, Python control flow and capture-unsafe
calls in captured code, host syncs on the serving path, live host views
(counterpart of ``repro/analysis/passes/trace_hazard.py``).

Three rule families:

* Inside capture-reachable functions and ``with torch.cuda.graph(...)``
  bodies (per the module-local approximation in
  :mod:`repro_torch.analysis.torchast`):

  - ``trace-hazard/host-sync``     ``.item()`` / ``.tolist()`` /
    ``.cpu()`` / ``.numpy()`` / ``.nonzero()`` / ``.to(<cpu>)`` anywhere,
    ``torch.cuda.synchronize``, ``torch.nonzero``, ``torch.bincount``,
    and ``np.asarray`` / ``np.array`` on a value derived from an operand.
    A capture that meets one fails (the thread-local error mode raises)
    or, worse, bakes the value it read into the graph.
  - ``trace-hazard/host-cast``     ``int()``/``float()``/``bool()`` on a
    value derived from an operand (shape/static expressions exempt).
  - ``trace-hazard/python-control-flow``  ``if``/``while`` whose test
    depends on an operand (``is None`` / isinstance / string-compare
    guards exempt): the capture records one branch for every replay.
  - ``trace-hazard/capture-unsafe-call``  a ``torch.distributed``
    collective or barrier, the port's collective helpers
    (``sharding.routing_rules.gather_rows`` / ``sum_rows``),
    ``gc.collect`` or ``torch.cuda.empty_cache``: a collective inside a
    capture is recorded against one communicator state and a collection
    that frees graphs breaks the capture.

* In every function of a ``serving/`` module, captured or not
  (``trace-hazard/serving-host-sync``): the serving hot path must stay
  dispatch-async, so any of the host-sync forms above, or
  ``int(...)``/``float(...)``/``bool(...)`` wrapping a call result, forces
  a device sync per batch and gets flagged. Shape reads like
  ``int(x.shape[0])`` stay legal. Findings here are either fixed or
  carried in the baseline with a reason (the control-plane reads).

* ``trace-hazard/live-view`` (in place of the reference's donation rules:
  torch donates no buffers): a ``serving/`` function returns, directly or
  inside a tuple, list or dict literal, the result of ``.cpu()`` or
  ``.to(<cpu>)`` without ``copy=True`` (or ``.numpy()`` of one, or a
  local bound to one). On a CPU service that result is the live tensor a
  later call writes in place.

Operand-ness is a syntactic taint: positional parameters of a reachable
function seed the set, assignments whose right-hand side mentions a
tainted name extend it. Keyword-only parameters, and parameters annotated
as a host scalar (``int``, ``float``, ``bool``, ``str``), are static:
configuration bound before the capture.
"""
from __future__ import annotations

import ast
from typing import Iterable

from ..engine import AnalysisContext, Finding
from ..torchast import (FuncInfo, alias_map, capture_blocks,
                        capture_reachable, collect_functions, contains_call,
                        resolves_to)

R_SYNC = "trace-hazard/host-sync"
R_CAST = "trace-hazard/host-cast"
R_FLOW = "trace-hazard/python-control-flow"
R_UNSAFE = "trace-hazard/capture-unsafe-call"
R_SERVE = "trace-hazard/serving-host-sync"
R_LIVE = "trace-hazard/live-view"

NUMPY_HOST = {"numpy.asarray", "numpy.array", "numpy.ascontiguousarray"}
TORCH_HOST = {"torch.cuda.synchronize", "torch.nonzero", "torch.bincount"}
STATIC_CALLS = {"len", "isinstance", "type", "hasattr", "getattr",
                "numpy.shape", "torch.numel"}
SHAPE_ATTRS = {"shape", "ndim", "size", "dtype", "itemsize", "nbytes",
               "device", "is_cuda", "requires_grad"}
HOST_METHODS = {"item", "tolist", "cpu", "numpy", "nonzero"}
# tensor methods that read host-side metadata, never the card
META_METHODS = {"size", "dim", "numel", "stride", "storage_offset",
                "element_size", "is_contiguous", "data_ptr",
                "untyped_storage", "get_device"}
HOST_SCALARS = {"int", "float", "bool", "str"}
COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_to_all",
    "all_to_all_single", "reduce_scatter", "reduce_scatter_tensor",
    "broadcast", "reduce", "gather", "scatter", "barrier",
    "monitored_barrier", "send", "recv", "isend", "irecv",
    "all_gather_object", "broadcast_object_list", "gather_object",
    "scatter_object_list", "batch_isend_irecv",
}
UNSAFE_CALLS = {"gc.collect", "torch.cuda.empty_cache",
                "repro_torch.sharding.routing_rules.gather_rows",
                "repro_torch.sharding.routing_rules.sum_rows"}
UNSAFE_CALLS |= {f"torch.distributed.{c}" for c in COLLECTIVES}


def _is_cpu_device(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")`` (any index)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] == "cpu"
    if (isinstance(node, ast.Call) and node.args
            and (getattr(node.func, "attr", None) == "device"
                 or getattr(node.func, "id", None) == "device")):
        return _is_cpu_device(node.args[0])
    return False


def _to_cpu(call: ast.Call) -> bool:
    """``x.to(<cpu>, ...)`` or ``x.to(device=<cpu>)``."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    if call.args and _is_cpu_device(call.args[0]):
        return True
    return any(kw.arg == "device" and _is_cpu_device(kw.value)
               for kw in call.keywords)


def _host_sync(call: ast.Call, aliases) -> str | None:
    """What makes ``call`` read the card on the host, or None (the
    argument-free host methods, a copy to the CPU, the torch host calls)."""
    f = call.func
    if (isinstance(f, ast.Attribute) and f.attr in HOST_METHODS
            and not call.args):
        return f".{f.attr}()"
    if _to_cpu(call):
        return ".to(<cpu>)"
    hit = resolves_to(f, aliases, TORCH_HOST)
    if hit:
        return hit
    return None


def _is_static(node: ast.AST, tainted: set[str],
               aliases: dict[str, str]) -> bool:
    """True when evaluating ``node`` cannot touch a device value."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return node.id not in tainted
    if isinstance(node, ast.Attribute):
        if node.attr in SHAPE_ATTRS:
            return True          # shapes/dtypes live on the host
        return _is_static(node.value, tainted, aliases)
    if isinstance(node, ast.Subscript):
        return (_is_static(node.value, tainted, aliases)
                and _is_static(node.slice, tainted, aliases))
    if isinstance(node, ast.Call):
        # len() of a tensor is its leading dim; isinstance and friends
        # never read the card. int(x.shape[0])-style casts of static
        # expressions stay static. ``x.size(0)``, ``x.data_ptr()`` and the
        # other metadata reads stay on the host. Anything else is assumed
        # dynamic.
        if (isinstance(node.func, ast.Name)
                and node.func.id in ("int", "float", "bool")):
            return all(_is_static(a, tainted, aliases) for a in node.args)
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in META_METHODS):
            return True
        return resolves_to(node.func, aliases, STATIC_CALLS) is not None
    if isinstance(node, (ast.BinOp, ast.BoolOp, ast.Compare, ast.UnaryOp,
                         ast.IfExp, ast.Tuple, ast.List, ast.Set)):
        return all(_is_static(c, tainted, aliases)
                   for c in ast.iter_child_nodes(node)
                   if not isinstance(c, (ast.operator, ast.boolop,
                                         ast.cmpop, ast.unaryop,
                                         ast.expr_context)))
    return False


def _static_params(fn: FuncInfo) -> set[str]:
    """Parameters annotated as host scalars (``b: int``)."""
    a = fn.node.args
    return {p.arg for p in a.posonlyargs + a.args
            if p.annotation is not None
            and ast.unparse(p.annotation).split("|")[0].strip()
            in HOST_SCALARS}


def _taint_set(fn: FuncInfo, body: list | None = None) -> set[str]:
    tainted = {p for p in fn.pos_params if p != "self"} - _static_params(fn)
    # One forward sweep: an assignment whose RHS mentions taint taints its
    # targets, unless the RHS is a static (shape-like) expression.
    for node in (n for st in (body or [fn.node]) for n in ast.walk(st)):
        if isinstance(node, ast.Assign):
            value, targets = node.value, node.targets
        elif isinstance(node, ast.AugAssign):
            value, targets = node.value, [node.target]
        else:
            continue
        names = {n.id for n in ast.walk(value) if isinstance(n, ast.Name)}
        if not (names & tainted):
            continue
        if _is_static(value, tainted, {}):
            continue
        for t in targets:
            for leaf in ast.walk(t):
                if isinstance(leaf, ast.Name):
                    tainted.add(leaf.id)
    return tainted


def _exempt_test(test: ast.AST) -> bool:
    """Static-dispatch guards that look tainted but never read the card."""
    if isinstance(test, ast.Compare):
        if any(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
            return True
        operands = [test.left, *test.comparators]
        if any(isinstance(o, ast.Constant) and isinstance(o.value, str)
               for o in operands):
            return True
    if isinstance(test, ast.Call):
        return True    # callable(..)/isinstance(..)-style predicate guards
    if isinstance(test, ast.BoolOp):
        return all(_exempt_test(v) for v in test.values)
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _exempt_test(test.operand)
    return False


def _scan_captured(mod, fn: FuncInfo, aliases,
                   body: list | None = None) -> Iterable[Finding]:
    """The capture rules over ``fn`` (or only the statements ``body`` of
    it: a capture block inside an uncaptured function)."""
    tainted = _taint_set(fn, body)
    own_nested = {n for n in ast.walk(fn.node)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and n is not fn.node}

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if child in own_nested:
                continue          # nested defs are scanned as themselves
            yield child
            yield from walk(child)

    roots = body if body is not None else [fn.node]
    nodes = [n for r in roots
             for n in ([r] if body is not None else []) + list(walk(r))]
    for node in nodes:
        if isinstance(node, ast.Call):
            sync = _host_sync(node, aliases)
            unsafe = resolves_to(node.func, aliases, UNSAFE_CALLS)
            if sync is not None:
                yield Finding(mod.rel, node.lineno, R_SYNC, fn.qualname,
                              f"{sync} forces a host sync inside captured "
                              "code")
            elif unsafe:
                yield Finding(mod.rel, node.lineno, R_UNSAFE, fn.qualname,
                              f"{unsafe}(...) cannot run inside a CUDA "
                              "graph capture — call it before or after "
                              "the captured program")
            elif resolves_to(node.func, aliases, NUMPY_HOST):
                if any(not _is_static(a, tainted, aliases)
                       for a in node.args):
                    yield Finding(mod.rel, node.lineno, R_SYNC, fn.qualname,
                                  "numpy conversion of a device value "
                                  "pulls it to host")
            elif (isinstance(node.func, ast.Name)
                  and node.func.id in ("int", "float", "bool")
                  and node.args
                  and not _is_static(node.args[0], tainted, aliases)):
                yield Finding(mod.rel, node.lineno, R_CAST, fn.qualname,
                              f"{node.func.id}() on a device value reads "
                              "it on the host")
        elif isinstance(node, (ast.If, ast.While)):
            test = node.test
            if (not _is_static(test, tainted, aliases)
                    and not _exempt_test(test)):
                kind = "if" if isinstance(node, ast.If) else "while"
                yield Finding(mod.rel, node.lineno, R_FLOW, fn.qualname,
                              f"python `{kind}` on a device value — the "
                              "capture records one branch; use "
                              "torch.where / a masked update")


def _scan_serving(mod, fn: FuncInfo, aliases,
                  already: set) -> Iterable[Finding]:
    for node in ast.walk(fn.node):
        if not isinstance(node, ast.Call):
            continue
        key = (node.lineno, node.col_offset)
        if key in already:
            continue
        sync = _host_sync(node, aliases)
        if sync is not None:
            already.add(key)
            yield Finding(mod.rel, node.lineno, R_SERVE, fn.qualname,
                          f"{sync} syncs the serving loop with the device")
        elif resolves_to(node.func, aliases, NUMPY_HOST):
            already.add(key)
            yield Finding(mod.rel, node.lineno, R_SERVE, fn.qualname,
                          "np conversion materializes device results in "
                          "the serving path")
        elif (isinstance(node.func, ast.Name)
              and node.func.id in ("int", "float", "bool")
              and node.args and contains_call(node.args[0])):
            already.add(key)
            yield Finding(mod.rel, node.lineno, R_SERVE, fn.qualname,
                          f"{node.func.id}(...) around a computed value "
                          "blocks on the device per call")


def _live_view(node: ast.AST, views: set[str]) -> bool:
    """``node`` is a host view that may alias a live CPU tensor."""
    if isinstance(node, ast.Name):
        return node.id in views
    if not isinstance(node, ast.Call) or not isinstance(node.func,
                                                        ast.Attribute):
        return False
    if node.func.attr == "cpu" and not node.args:
        return True
    if _to_cpu(node):
        return not any(kw.arg == "copy" and isinstance(kw.value, ast.Constant)
                       and kw.value.value is True for kw in node.keywords)
    if node.func.attr == "numpy" and not node.args:
        return _live_view(node.func.value, views)
    return False


def _returned(node: ast.AST) -> Iterable[ast.AST]:
    """The values a return statement hands out, through literals."""
    if isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            yield from _returned(e)
    elif isinstance(node, ast.Dict):
        for v in node.values:
            yield from _returned(v)
    elif node is not None:
        yield node


def _scan_live_views(mod, fn: FuncInfo) -> Iterable[Finding]:
    nested = {n for n in ast.walk(fn.node)
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)) and n is not fn.node}
    skip = {c for n in nested for c in ast.walk(n)}
    stmts = sorted((st for st in ast.walk(fn.node)
                    if isinstance(st, (ast.Assign, ast.Return))
                    and st not in skip),
                   key=lambda st: (st.lineno, st.col_offset))
    views: set[str] = set()
    for st in stmts:
        if isinstance(st, ast.Assign):
            live = _live_view(st.value, views)
            for t in st.targets:
                if isinstance(t, ast.Name):
                    (views.add if live else views.discard)(t.id)
            continue
        for v in _returned(st.value):
            if _live_view(v, views):
                yield Finding(mod.rel, v.lineno, R_LIVE, fn.qualname,
                              "returns a host view that is the live tensor "
                              "on a CPU service — a later call writes it "
                              "in place; copy it (.to('cpu', copy=True))")


def _enclosing(funcs: list[FuncInfo], node: ast.AST) -> FuncInfo | None:
    """The innermost function whose body holds ``node``."""
    best = None
    for f in funcs:
        if (any(n is node for n in ast.walk(f.node)) and (
                best is None
                or f.qualname.count(".") > best.qualname.count("."))):
            best = f
    return best


def run(ctx: AnalysisContext) -> Iterable[Finding]:
    out: list[Finding] = []
    for mod in ctx.modules:
        aliases = alias_map(mod.tree)
        reachable = capture_reachable(mod.tree, aliases)
        for fn in reachable.values():
            out.extend(_scan_captured(mod, fn, aliases))
        funcs = collect_functions(mod.tree)
        for blk in capture_blocks(mod.tree, aliases):
            fn = _enclosing(funcs, blk)
            if fn is not None and fn.node not in reachable:
                out.extend(_scan_captured(mod, fn, aliases, blk.body))
        if "serving/" in mod.rel or mod.rel.startswith("serving"):
            reach_lines = {f.line for f in out if f.path == mod.rel}
            already: set = set()
            for fn in funcs:
                for f in _scan_serving(mod, fn, aliases, already):
                    if f.line not in reach_lines:
                        out.append(f)
                out.extend(_scan_live_views(mod, fn))
    return out
