"""Pass 5 — protocol conformance + hand-kernel dispatch and budget
(counterpart of ``repro/analysis/passes/protocol_kernel.py``).

Protocol half (``protocol/*``), the reference's rules unchanged: every
``RoutingPolicy(...)`` construction is checked against the protocol's slot
arities, and every policy factory must take the pool description first
(ROADMAP: "must accept a ModelPool first argument").

* ``protocol/registry-drift`` — the ``RoutingPolicy`` NamedTuple grew or
  renamed a slot this pass doesn't know; the arity table below must be
  updated in the same PR (this is deliberate: protocol changes should
  touch the lint).
* ``protocol/arity`` — a callable bound to a slot whose positional-arg
  count differs from the protocol arity (resolved against same-module
  ``def``s; ``*args`` and unresolvable names are skipped).
* ``protocol/pool-first`` — a factory (a function that directly returns
  or builds a ``RoutingPolicy(...)``) whose first parameter is neither
  pool-like by name nor annotated with a pool/array type.  Combinators
  taking an existing ``RoutingPolicy`` first are exempt.

Kernel half (``kernel/*``), scoped to modules under ``kernels/``. The
reference's Pallas rules (tile alignment, the VMEM budget, one
``MAX_K_FUSED``) mean nothing for hand-written CUDA kernels; in their
place:

* ``kernel/smem-budget`` — a module-level ``*_SMEM_BYTES`` constant whose
  value (integer arithmetic over literals and earlier module constants)
  exceeds the H100's 227 KiB of shared memory a block: a plan that admits
  a configuration the card cannot launch.
* ``kernel/silent-fallback`` — a ``try`` whose handler calls a
  ``*_plain`` function, or a test of which card is present
  (``torch.cuda.is_available()``, its capability or properties) that
  selects one: a wrapper must launch its kernel on a CUDA tensor or raise,
  and take the plain version only for a CPU tensor (ROADMAP, "Dispatch").
"""
from __future__ import annotations

import ast
from typing import Iterable

from ..engine import AnalysisContext, Finding
from ..torchast import alias_map, collect_functions, dotted_name, resolves_to

R_DRIFT = "protocol/registry-drift"
R_ARITY = "protocol/arity"
R_POOL = "protocol/pool-first"
R_SMEM = "kernel/smem-budget"
R_FALLBACK = "kernel/silent-fallback"

# RoutingPolicy slot -> positional arity of the bound callable.  Must track
# src/repro_torch/core/policy.py; registry-drift fires when it doesn't.
PROTOCOL_ARITY = {
    "init": 1,            # (key)
    "act": 3,             # (state, key, x)
    "update": 5,          # (state, x, a1, a2, y)
    "update_delayed": 6,  # (state, x, a1, a2, y, age)
    "update_masked": 6,   # (state, x, a1, a2, y, ok)
    "act_masked": 5,      # (state, key, x, a1, a2)  [forced-pair variant]
    "act_pref": 5,        # (state, key, x, prefs, ...)
    "update_pref": 7,     # (state, x, a1, a2, y, age, prefs)
    "propensity": 4,      # (state, x, a1, a2) — logging-propensity readout
}
NON_CALLABLE_SLOTS = {"name"}

POOLISH_PARAM_NAMES = {"a_emb", "pool", "pool0", "arms", "model_pool",
                       "n_models", "entries"}
POOLISH_ANNOTATIONS = ("ModelPool", "Array", "ndarray")

SMEM_BYTES = 227 * 1024   # a block's shared memory on the H100 (sm_90)
# calls that read which card (if any) runs: a dispatch on them can pick
# the plain version where the kernel should have run or raised
CARD_PROBES = {"torch.cuda.is_available", "torch.cuda.get_device_capability",
               "torch.cuda.get_device_properties", "torch.cuda.device_count"}


# ---------------------------------------------------------------------------
# protocol half
# ---------------------------------------------------------------------------

def _routing_policy_fields(ctx: AnalysisContext) -> tuple[list[str], str, int]:
    for mod in ctx.modules:
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.ClassDef)
                    and node.name == "RoutingPolicy"):
                fields = [st.target.id for st in node.body
                          if isinstance(st, ast.AnnAssign)
                          and isinstance(st.target, ast.Name)]
                return fields, mod.rel, node.lineno
    return [], "", 0


def _local_defs(tree: ast.Module) -> dict[str, list[ast.FunctionDef]]:
    out: dict[str, list[ast.FunctionDef]] = {}
    for fn in collect_functions(tree):
        if isinstance(fn.node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(fn.node.name, []).append(fn.node)
    return out


def _slot_callables(value: ast.AST) -> Iterable[str]:
    """Candidate local-def names bound to a slot (through IfExp/BoolOp)."""
    if isinstance(value, ast.Name) and value.id != "None":
        yield value.id
    elif isinstance(value, ast.IfExp):
        yield from _slot_callables(value.body)
        yield from _slot_callables(value.orelse)
    elif isinstance(value, ast.BoolOp):
        for v in value.values:
            yield from _slot_callables(v)


def _check_protocol(ctx: AnalysisContext) -> Iterable[Finding]:
    fields, def_path, def_line = _routing_policy_fields(ctx)
    if fields:
        known = set(PROTOCOL_ARITY) | NON_CALLABLE_SLOTS
        for f in fields:
            if f not in known:
                yield Finding(def_path, def_line, R_DRIFT, "RoutingPolicy",
                              f"protocol slot `{f}` unknown to repro-lint — "
                              "update PROTOCOL_ARITY in "
                              "analysis/passes/protocol_kernel.py")
        for f in PROTOCOL_ARITY:
            if f not in fields:
                yield Finding(def_path, def_line, R_DRIFT, "RoutingPolicy",
                              f"repro-lint expects slot `{f}` which the "
                              "protocol no longer declares — update "
                              "PROTOCOL_ARITY")

    for mod in ctx.modules:
        defs = _local_defs(mod.tree)
        factory_fns: set[ast.AST] = set()
        fn_of: dict[ast.AST, ast.FunctionDef] | None = None
        for call in ast.walk(mod.tree):
            if not (isinstance(call, ast.Call)
                    and (dotted_name(call.func) or "").split(".")[-1]
                    == "RoutingPolicy"
                    and call.keywords):
                continue
            if fn_of is None:        # built on the module's first policy
                fn_of = {}
                for fn in collect_functions(mod.tree):
                    if isinstance(fn.node, (ast.FunctionDef,
                                            ast.AsyncFunctionDef)):
                        for sub in ast.walk(fn.node):
                            fn_of.setdefault(sub, fn.node)
            owner = fn_of.get(call)
            if owner is not None:
                factory_fns.add(owner)
            pos_fields = fields or list(PROTOCOL_ARITY)
            slot_values = {kw.arg: kw.value for kw in call.keywords
                           if kw.arg is not None}
            for i, arg in enumerate(call.args):
                if i < len(pos_fields):
                    slot_values.setdefault(pos_fields[i], arg)
            for slot, value in slot_values.items():
                want = PROTOCOL_ARITY.get(slot)
                if want is None:
                    continue
                for name in _slot_callables(value):
                    for d in defs.get(name, []):
                        a = d.args
                        if a.vararg is not None:
                            continue
                        got = len(a.posonlyargs) + len(a.args)
                        if got != want:
                            yield Finding(
                                mod.rel, call.lineno, R_ARITY, name,
                                f"slot `{slot}` wants {want} positional "
                                f"args, `{name}` takes {got} — the policy "
                                "will fail at trace time under the generic "
                                "loop")
        for owner in factory_fns:
            args = owner.args
            params = [p.arg for p in args.posonlyargs + args.args]
            params = [p for p in params if p != "self"]
            if not params:
                continue
            first = args.posonlyargs + args.args
            first = [p for p in first if p.arg != "self"][0]
            ann = ast.unparse(first.annotation) if first.annotation else ""
            if "RoutingPolicy" in ann:
                continue   # combinator wrapping an existing policy
            if first.arg in POOLISH_PARAM_NAMES:
                continue
            if any(tok in ann for tok in POOLISH_ANNOTATIONS):
                continue
            yield Finding(
                mod.rel, owner.lineno, R_POOL, owner.name,
                f"policy factory's first parameter `{first.arg}` is not "
                "the pool/embedding table — ROADMAP requires pool-first "
                "factories")




# ---------------------------------------------------------------------------
# kernel half
# ---------------------------------------------------------------------------

def _eval_int(node: ast.AST, env: dict[str, int]) -> int | None:
    """Integer arithmetic over literals and known names, else None."""
    if (isinstance(node, ast.Constant) and isinstance(node.value, int)
            and not isinstance(node.value, bool)):
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _eval_int(node.operand, env)
        return None if v is None else -v
    if isinstance(node, ast.BinOp):
        lo, hi = _eval_int(node.left, env), _eval_int(node.right, env)
        if lo is None or hi is None:
            return None
        if isinstance(node.op, ast.Add):
            return lo + hi
        if isinstance(node.op, ast.Sub):
            return lo - hi
        if isinstance(node.op, ast.Mult):
            return lo * hi
        if isinstance(node.op, ast.FloorDiv) and hi:
            return lo // hi
        if isinstance(node.op, ast.LShift):
            return lo << hi
    return None


def _smem_budgets(mod) -> Iterable[Finding]:
    env: dict[str, int] = {}
    for node in mod.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        name = node.targets[0].id
        val = _eval_int(node.value, env)
        if val is None:
            continue
        env[name] = val
        if name.endswith("_SMEM_BYTES") and val > SMEM_BYTES:
            yield Finding(mod.rel, node.lineno, R_SMEM, name,
                          f"{name} = {val} bytes exceeds the "
                          f"{SMEM_BYTES} bytes of shared memory a block "
                          "has on the H100 — a plan under this budget can "
                          "pick a launch the card refuses")


def _calls_plain(nodes) -> str | None:
    for stmt in nodes:
        for n in ast.walk(stmt):
            if isinstance(n, ast.Call):
                name = (dotted_name(n.func) or "").split(".")[-1]
                if name.endswith("_plain"):
                    return name
    return None


def _silent_fallbacks(mod, aliases) -> Iterable[Finding]:
    funcs = collect_functions(mod.tree)
    owner = {}
    for fn in funcs:
        for sub in ast.walk(fn.node):
            owner[sub] = fn.qualname       # innermost def wins (walk order)
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Try):
            for h in node.handlers:
                plain = _calls_plain(h.body)
                if plain:
                    yield Finding(
                        mod.rel, h.lineno, R_FALLBACK, owner.get(node, ""),
                        f"exception handler falls back to {plain}() — a "
                        "kernel that fails to build or launch must raise, "
                        "not run its plain version")
        elif isinstance(node, (ast.If, ast.IfExp)):
            probe = next((resolves_to(n.func, aliases, CARD_PROBES)
                          for n in ast.walk(node.test)
                          if isinstance(n, ast.Call)
                          and resolves_to(n.func, aliases, CARD_PROBES)),
                         None)
            if probe is None:
                continue
            body = node.body if isinstance(node.body, list) else [node.body]
            orelse = node.orelse if isinstance(node.orelse, list) \
                else [node.orelse]
            plain = _calls_plain(body + orelse)
            if plain:
                yield Finding(
                    mod.rel, node.lineno, R_FALLBACK, owner.get(node, ""),
                    f"{probe.rsplit('.', 1)[-1]}() selects {plain}() — "
                    "dispatch on the tensor's device: the plain version "
                    "for a CPU tensor, the kernel (or an error) for a CUDA "
                    "one")


def _check_kernels(ctx: AnalysisContext) -> Iterable[Finding]:
    for mod in ctx.modules:
        if "kernels/" not in mod.rel and not mod.rel.startswith("kernels"):
            continue
        yield from _smem_budgets(mod)
        yield from _silent_fallbacks(mod, alias_map(mod.tree))


def run(ctx: AnalysisContext) -> Iterable[Finding]:
    out = list(_check_protocol(ctx))
    out.extend(_check_kernels(ctx))
    return out
