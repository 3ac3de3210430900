"""LM dry-run: one rank of the production meshes, reckoned (counterpart of
``repro/launch/dryrun.py``).

The reference lowers and compiles every (architecture x input shape) onto
the 16 x 16 and 2 x 16 x 16 TPU meshes and records XLA's memory and cost
analysis and the collectives it parses from the HLO. Torch has no
ahead-of-time compile of a partitioned program, so nothing is lowered
here. Instead, for every (arch, shape, mesh) where ``applicable`` holds,
the port reckons what one rank does under the specs of
``sharding/rules.py`` (on a ``DeviceMesh`` over a world of 256 or 512
ranks of the ``fake`` back end, or on any object with ``axis_names`` and a
``shape`` mapping):

* the bytes of its parameter, optimizer-state, gradient, cache and input
  shares, from ``routing_rules.local_shape`` of the specs (activations are
  not reckoned);
* its FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one unit
  on fake tensors at the rank's local shapes, times the unit count, plus
  the remainder, the encoder units and the head (embedding, logits,
  loss). The unit is forward and backward for train (plus the forward
  again that ``lm.forward``'s rematerialisation runs for ``units`` and
  ``enc_units``), forward for prefill, one token for decode: the
  reference's per-unit probe idea. The kernels' own operations are counted
  by formula where the unit calls them (``KernelRecorder``): attention 4 D
  a live (query, key) pair forward and 10 D backward, the SSD scan by its
  chunked products, the RG-LRU scan none (it is elementwise);
* the bytes each collective of the rank program below moves (its output
  on this rank, as the reference counts XLA's), by operation. These are
  the port's rank program's collectives, not XLA's; each record names the
  specs that imply it (``why``).

**The rank program** (Megatron style, as the specs imply), run by the
reckoning on fake tensors and by ``time_shares`` on the card. Its
full-sequence forward is the model's own ``blocks.block_fwd`` with the
rank's hooks (``RankHooks``, on ``models/hooks.py``): the collectives at
the projection boundaries, the kernels through ``KernelFns`` or the
reckoning's ``KernelRecorder``. ``RankProgram`` adds what the model has
no step for: the ``fsdp`` gathers, the MoE's rank program, the
vocab-parallel head, and decode (``block_step``), whose attention scores
a cache shard of head_dim slices and all-reduces the partial scores, and
whose SSD step runs the rank's heads of the state; the model's one-device
decode has neither step, and decode runs no kernel:

* column-parallel input projections and row-parallel output projections
  over ``model``: the block's input enters with an all-reduce of its
  gradient in the backward, the output leaves with an all-reduce of the
  activations in the forward (fp32 partial sums for the SSD and RG-LRU
  out projections, which the blocks compute in fp32);
* attention split on heads (both head counts divide 16; only
  seamless-m4t-medium) runs on the rank's heads. Attention split on
  head_dim (the other nine) all-gathers q, k and v along head_dim over
  ``model`` (RoPE pairs dims d and d + D/2, which two ranks hold), runs
  whole-head attention on the rank's batch rows and keeps the rank's
  slice of the output; the backward all-gathers dO the same way. At
  granite-3-2b train_4k on 16 x 16 that receives 15/16 of 403 MB a layer
  forward; an all-reduce of the partial scores would move 16 x 32 x
  4096^2 x 4 bytes = 34.4 GB. The attention is then the same on the 16
  ranks of a model group; an all-to-all over the batch rows would split
  it 16 ways at the cost of two layout changes a layer (not taken here;
  PERF.md section 7). The repeat-KV layout (``gqa_impl="repeat"``)
  repeats the replicated K/V to the rank's query heads, no collective; the
  replicated K/V projections' gradients are all-reduced over ``model``;
* the RG-LRU all-gathers its conv output over ``model`` (its gates read
  every channel; reduce-scatter in the backward); the SSD block runs whole
  on every rank of the model group (``ssd_specs`` leave ``in_proj``
  replicated) and keeps the rank's slice for the row-parallel
  ``out_proj``; decode runs the rank's heads (its cache shard) with an
  all-reduce of the gated norm's sum of squares;
* MoE: the expert d_ff split runs like the MLP; expert-parallel layers
  (arctic) run the rank's experts on every token and all-reduce; the
  router's gradient is all-reduced over ``model``;
* vocab-parallel embedding (all-reduce) and logits (the cross entropy's
  max, sum of exponentials and target logit all-reduced; prefill and
  decode all-gather the step's logits); a vocabulary that does not
  divide 16 splits d_model, and the table is all-gathered over ``model``;
* decode attention: q and the token's K/V all-gathered to whole heads,
  the rank's head_dim slice written to its cache shard, the partial
  scores all-reduced over ``model``;
* ``fsdp`` archs all-gather each unit's parameter shards over ``data``
  before use (again for the rematerialised forward) and reduce-scatter
  their gradients; for train, every gradient shard is all-reduced over
  the batch axes it is replicated on (``pod`` too for ``fsdp`` shards).

``time_shares`` runs one rank's share of one unit on the card at the
local shapes of ``SHARES`` (train_4k on 16 x 16, local batch 16) with the
collectives left out (``Comm`` stands in: a gather tiles the rank's slice,
a reduce passes its input), times each kernel, and runs the share again
on the plain versions (``compare_share``). ``plan`` lists the kernel calls
a share makes, the shapes the wrappers must take; ``unit_share_bytes``
counts its shards' bytes from the model's own unit.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only] [--out FILE]

The fake world is made and destroyed here; it cannot share a process with
a started world (run it before ``init_world`` or after ``close_world``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import types

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import profiling
from repro_torch.configs import ARCHS, SHAPES, get_arch, long_ctx_supported
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru_scan as rgs
from repro_torch.kernels import ssd_scan as sss
from repro_torch.kernels.sgld_update import softplus
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import blocks as blk
from repro_torch.models import lm
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssd as ssd_lib
from repro_torch.models.config import (FFN_MLP, FFN_NONE, MIXER_CROSS_ATTN,
                                       MIXER_LOCAL_ATTN, MIXER_RGLRU,
                                       MIXER_SSD)
from repro_torch.models.layers import (apply_rope, gated_mlp, rms_norm,
                                       softcap, tree_leaves, tree_map)
from repro_torch.sharding import rules
from repro_torch.sharding.routing_rules import local_shape

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CARD_BYTES = 80e9          # one H100's memory


def plain_mesh(name: str):
    """A production mesh as plain data (axis names and sizes, no world)."""
    shape, axes = MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes)


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in rules.mesh_axis_sizes(mesh).values())


def applicable(arch: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return long_ctx_supported(arch)
    return True


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# Collectives: recorded, with a local stand-in for the values
# ---------------------------------------------------------------------------

class Comm:
    """The rank program's collectives over named mesh axes. Each one is
    recorded (``records``: op, axes, output bytes on this rank, the specs
    that imply it) and its value stood in for locally: an all-gather
    tiles the rank's slice, an all-reduce passes its input, a
    reduce-scatter keeps the first slice. Over axes of size 1 each is the
    identity and nothing is recorded. ``index(axes)`` is this rank's
    position along ``axes`` (0 here)."""

    def __init__(self, sizes: dict):
        self.sizes = dict(sizes)
        self.records: list = []

    def n(self, axes) -> int:
        return math.prod(self.sizes[a] for a in axes)

    def index(self, axes) -> int:
        return 0

    def exchange(self, kind, x, dim, axes):
        """The collective's value: the local stand-in."""
        n = self.n(axes)
        if kind.startswith("all_reduce"):
            return x
        if kind == "all_gather":
            reps = [1] * x.dim()
            reps[dim] = n
            return x.repeat(*reps)
        size = x.shape[dim] // n
        return x.narrow(dim, self.index(axes) * size, size).contiguous()

    def apply(self, x, op):
        """``op``: None, or (kind, dim, axes, why) with kind in
        all_reduce, all_reduce_max, all_gather, reduce_scatter, slice."""
        if op is None:
            return x
        kind, dim, axes, why = op
        n = self.n(axes)
        if n == 1:
            return x
        if kind == "slice":
            size = x.shape[dim] // n
            return x.narrow(dim, self.index(axes) * size, size).contiguous()
        out = self.exchange(kind, x, dim, axes)
        op = "all_reduce" if kind.startswith("all_reduce") else kind
        self.records.append(dict(op=op, axes=tuple(axes),
                                 bytes=_nbytes(out), why=tuple(why)))
        return out


class _Coll(torch.autograd.Function):
    """One op in the forward, another on the gradient in the backward."""

    @staticmethod
    def forward(ctx, x, comm, fwd, bwd):
        ctx.comm, ctx.bwd = comm, bwd
        out = comm.apply(x, fwd)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.apply(g.contiguous(), ctx.bwd), None, None, None


# ---------------------------------------------------------------------------
# The kernels a rank program calls
# ---------------------------------------------------------------------------

# the plain attention's dense scores, in elements, held at once
PLAIN_SCORES = 1 << 29


class _PlainByRows(torch.autograd.Function):
    """The plain attention over a few batch rows at a time (at most
    ``PLAIN_SCORES`` scores), each chunk's backward recomputed from its
    inputs: a share's dense scores would not fit the card at once."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        ctx.save_for_backward(q, k, v)
        ctx.kw = kw
        b, h, s, _ = q.shape
        ctx.rows = max(1, PLAIN_SCORES // (h * s * k.shape[2]))
        return torch.cat([fa.flash_attention_plain(
            q[i:i + ctx.rows], k[i:i + ctx.rows], v[i:i + ctx.rows], **kw)
            for i in range(0, b, ctx.rows)])

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        grads = [torch.empty_like(t) for t in (q, k, v)]
        for i in range(0, q.shape[0], ctx.rows):
            rows = slice(i, i + ctx.rows)
            with torch.enable_grad():
                ins = [t[rows].detach().requires_grad_(True)
                       for t in (q, k, v)]
                out = fa.flash_attention_plain(*ins, **ctx.kw)
                for g, gi in zip(grads, torch.autograd.grad(
                        out, ins, do[rows])):
                    g[rows] = gi
        return (*grads, None)


class KernelFns:
    """The kernel wrappers a rank program runs, by the wrappers' names and
    arguments: the wrappers (kernels on the card, plain versions on the
    CPU) or, with ``plain=True``, the plain versions everywhere (the
    attention a few batch rows at a time: ``_PlainByRows``)."""

    def __init__(self, plain: bool = False):
        self.plain = plain

    def flash_attention(self, q, k, v, **kw):
        if self.plain:
            return _PlainByRows.apply(q, k, v, kw)
        return fa.flash_attention(q, k, v, **kw)

    def ssd_scan(self, x, bt, ct, log_a, dt, h0=None, *, chunk):
        fn = sss.ssd_scan_plain if self.plain else sss.ssd_scan
        return fn(x, bt, ct, log_a, dt, h0, chunk=chunk)

    def rglru_scan(self, log_a, x_in, h0=None):
        fn = rgs.rglru_scan_plain if self.plain else rgs.rglru_scan
        return fn(log_a, x_in, h0)


def live_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs the attention mask keeps: key j < T, j <= i when
    causal, j > i - window when windowed."""
    i = np.arange(s, dtype=np.int64)
    hi = np.minimum(i, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(s, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def ssd_flops(b, s, h, p, n, chunk, backward=False) -> float:
    """The chunked SSD's products (``chip_smoke.py``'s count): per chunk of
    l steps, C.B^T's causal half once per batch row and, per head, the
    causal W x and 2 l N P each for C.state and the state update (the
    backward: both products' gradients)."""
    total = 0.0
    for c in range(0, s, chunk):
        l = min(chunk, s - c)
        total += b * l * (l + 1) * n
        total += b * h * ((2 * l * (l + 1) * (p + n) + 10 * l * n * p)
                          if backward else (l * (l + 1) * p + 4 * l * n * p))
    return total


def _shape_dtype(t):
    return dict(shape=tuple(int(x) for x in t.shape),
                stride=tuple(int(x) for x in t.stride()),
                dtype=str(t.dtype).replace("torch.", ""))


class _Stub(torch.autograd.Function):
    """A kernel call that returns outputs of the right shapes and records
    its backward call (the reckoning runs no kernel arithmetic)."""

    @staticmethod
    def forward(ctx, rec, call, outs, *inputs):
        ctx.rec, ctx.call = rec, call
        ctx.like = [(t.shape, t.dtype) for t in inputs]
        return tuple(inputs[0].new_empty(s, dtype=d) for s, d in outs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.rec.backward(ctx.call, grads)
        return (None, None, None,
                *(grads[0].new_zeros(s, dtype=d) for s, d in ctx.like))


class KernelRecorder:
    """Kernel entry points for the reckoning: each call is recorded
    (``calls``: kernel, its inputs' shapes, strides and dtypes, keywords)
    with its operations (``flops``), and its backward call too when the
    backward runs. No arithmetic: outputs are empty tensors."""

    def __init__(self):
        self.calls: list = []
        self.flops = 0.0

    def _record(self, kernel, tensors, flops, **kw):
        call = dict(kernel=kernel, args=[_shape_dtype(t) for t in tensors],
                    flops=float(flops), **kw)
        self.calls.append(call)
        self.flops += flops
        return call

    def flash_attention(self, q, k, v, *, causal, window, softcap, scale):
        b, h, s, d = q.shape
        live = live_pairs(s, k.shape[2], causal, window)
        call = self._record("flash_attention", (q, k, v), 4.0 * b * h * live
                            * d, causal=causal, window=window,
                            softcap=softcap, live=live)
        if not torch.is_grad_enabled() or not any(
                t.requires_grad for t in (q, k, v)):
            return q.new_empty(q.shape)
        return _Stub.apply(self, call, [(q.shape, q.dtype)], q, k, v)[0]

    def ssd_scan(self, x, bt, ct, log_a, dt, h0=None, *, chunk):
        b, s, h, p = x.shape
        n = bt.shape[-1]
        call = self._record("ssd_scan", (x, bt, ct, log_a, dt),
                            ssd_flops(b, s, h, p, n, chunk), chunk=chunk)
        outs = [((b, s, h, p), torch.float32), ((b, h, p, n), torch.float32)]
        if not torch.is_grad_enabled() or not any(
                t.requires_grad for t in (x, bt, ct, log_a, dt)):
            return tuple(x.new_empty(sh, dtype=d) for sh, d in outs)
        return _Stub.apply(self, call, outs, x, bt, ct, log_a, dt)

    def rglru_scan(self, log_a, x_in, h0=None):
        call = self._record("rglru_scan", (log_a, x_in), 0.0)
        outs = [(x_in.shape, torch.float32),
                ((x_in.shape[0], x_in.shape[2]), torch.float32)]
        if not torch.is_grad_enabled() or not any(
                t.requires_grad for t in (log_a, x_in)):
            return tuple(x_in.new_empty(sh, dtype=d) for sh, d in outs)
        return _Stub.apply(self, call, outs, log_a, x_in)

    def backward(self, call, grads):
        kernel = call["kernel"]
        args = [dict(a) for a in call["args"]]
        if kernel == "flash_attention":
            q = args[0]
            b, h, s, d = q["shape"]
            # q, k, v, o and dO; lse is (B, H, S) float32
            args += [dict(q), dict(q, stride=tuple(grads[0].stride()))]
            flops = 10.0 * b * h * call["live"] * d
            extra = {k: call[k] for k in ("causal", "window", "softcap",
                                          "live")}
        elif kernel == "ssd_scan":
            b, s, h, p = args[0]["shape"]
            n = args[1]["shape"][-1]
            args.append(_shape_dtype(grads[0]))
            flops = ssd_flops(b, s, h, p, n, call["chunk"], backward=True)
            extra = {"chunk": call["chunk"]}
        else:
            args += [dict(args[1], dtype="float32"), _shape_dtype(grads[0])]
            flops, extra = 0.0, {}
        self.calls.append(dict(kernel=kernel + "_bwd", args=args,
                               flops=flops, **extra))
        self.flops += flops


# ---------------------------------------------------------------------------
# The rank program
# ---------------------------------------------------------------------------

def _leaf(tree: dict, path: str):
    for key in path.split("."):
        tree = tree[key]
    return tree


def _axes_of(spec) -> set:
    out = set()
    for entry in spec:
        if entry is None:
            continue
        out |= {entry} if isinstance(entry, str) else set(entry)
    return out


class RankProgram:
    """One rank's program under ``sharding/rules.py`` (see the module
    docstring). ``mesh``: a ``DeviceMesh`` or a plain mesh; ``bx`` the
    batch axes of the step (``steps.step_batch_axes``); ``fns`` the kernel
    wrappers by name (``KernelFns`` or a ``KernelRecorder``); ``comm`` the
    collectives (``Comm``: recorded, stood in for locally)."""

    def __init__(self, cfg, mesh, bx, fns, comm: Comm | None = None):
        self.cfg, self.mesh, self.bx, self.fns = cfg, mesh, tuple(bx), fns
        self.sizes = rules.mesh_axis_sizes(mesh)
        self.m = self.sizes["model"]
        self.fsdp = rules.fsdp_axis(cfg, mesh)
        self.comm = comm if comm is not None else Comm(self.sizes)

    # -- collectives ------------------------------------------------------
    @property
    def mi(self) -> int:
        """This rank's index along ``model``."""
        return self.comm.index(("model",))

    def coll(self, x, fwd=None, bwd=None):
        return _Coll.apply(x, self.comm, fwd, bwd)

    def enter(self, x, why):
        """A column-parallel region's input: all-reduce of its gradient."""
        return self.coll(x, bwd=("all_reduce", None, ("model",), why))

    def leave(self, x, why):
        """A row-parallel output: all-reduce of the partial sums."""
        return self.coll(x, fwd=("all_reduce", None, ("model",), why))

    def gather(self, x, dim, why, axes=("model",), bwd="slice"):
        """All-gather along ``dim``; the gradient is sliced (the work after
        the gather is the same on every rank of ``axes``) or
        reduce-scattered (it is not)."""
        dim = dim % x.dim()
        return self.coll(x, fwd=("all_gather", dim, axes, why),
                         bwd=(bwd, dim, axes, why))

    def keep(self, x, dim, why):
        """The rank's slice along ``dim``; the gradient is all-gathered."""
        dim = dim % x.dim()
        return self.coll(x, fwd=("slice", dim, ("model",), why),
                         bwd=("all_gather", dim, ("model",), why))

    def grad_sum(self, w, why):
        """A weight replicated over ``model`` whose gradient each rank only
        has a part of: all-reduce of the gradient."""
        return self.coll(w, bwd=("all_reduce", None, ("model",), why))

    def shards(self, p: dict, sp: dict, path: str) -> dict:
        """The block's parameters, an ``fsdp`` arch's shards all-gathered
        over ``data`` (their gradients reduce-scattered)."""
        out = {}
        for k, v in p.items():
            where = f"{path}.{k}" if path else k
            if isinstance(v, dict):
                out[k] = self.shards(v, sp[k], where)
            elif self.fsdp and self.fsdp in sp[k]:
                out[k] = self.gather(v, list(sp[k]).index(self.fsdp),
                                     (f"params:{where}",),
                                     axes=(self.fsdp,),
                                     bwd="reduce_scatter")
            else:
                out[k] = v
        return out

    # -- local parameters -------------------------------------------------
    def block_specs(self, spec):
        return rules.block_specs(self.cfg, self.mesh, spec, self.fsdp)

    def unit_specs(self, specs) -> dict:
        return {str(i): self.block_specs(s) for i, s in enumerate(specs)}

    def unit_shapes(self, specs) -> dict:
        """{leaf: (local shape, dtype)} of one unit's shards."""
        sds = steps_lib.unit_params_specs(self.cfg, specs)
        return tree_map(lambda t, sp: (local_shape(sp, tuple(t.shape),
                                                   self.mesh), t.dtype),
                        sds, self.unit_specs(specs))

    # -- blocks -----------------------------------------------------------
    def layout(self, sp) -> str:
        """An attention's split: "heads", "dims" (head_dim) or "repeat"
        (K/V replicated)."""
        if sp["wk"][1] is None and sp["wk"][2] is None:
            return "repeat"
        return "heads" if sp["wq"][1] == "model" else "dims"

    def mlp(self, p, h, path):
        why = (f"params:{path}.w2",)
        return self.leave(gated_mlp(p, self.enter(h, why)), why)

    def moe(self, p, h, path, impl):
        cfg = self.cfg
        why = (f"params:{path}.w2",)
        h = self.enter(h, why)
        p = dict(p, router=self.grad_sum(p["router"],
                                         (f"params:{path}.router",
                                          f"params:{path}.w2")))
        if rules.experts_split(cfg, self.mesh):
            out, aux = self._moe_experts(p, h, impl)
        else:
            local = dataclasses.replace(cfg, d_ff=p["w1"].shape[-1])
            out, aux = moe_lib.moe_ffn(p, h, local, impl=impl)
        # every rank of the model group computes the whole load-balance
        # loss; each passes 1/16 of its gradient, which the all-reduces of
        # the block's input and the router sum to the whole
        aux = aux.detach() + (aux - aux.detach()) / self.m
        return self.leave(out, why), aux

    def _moe_experts(self, p, h, impl):
        """Expert-parallel MoE: route over all E experts, run the rank's
        E/16 on every token routed to them (the rest add zero)."""
        cfg = self.cfg
        b, s, d = h.shape
        n, k, e = b * s, cfg.top_k, cfg.n_experts
        el = p["w1"].shape[0]
        r0 = self.mi * el
        xf = h.reshape(n, d)
        gate, topi, aux = moe_lib._route(p, xf, cfg)
        if impl == "dense":
            combine = torch.zeros((n, e), dtype=torch.float32,
                                  device=h.device).scatter_add_(1, topi, gate)
            hh = torch.matmul(xf, p["w1"])
            g = torch.matmul(xf, p["w3"])
            y = torch.bmm(F.silu(hh) * g, p["w2"])
            out = torch.einsum("end,ne->nd", y,
                               combine[:, r0:r0 + el].to(y.dtype))
        else:
            c = moe_lib.capacity(n, cfg)
            dest, sort_idx, slot = moe_lib.dispatch(topi, e, c)
            buf = xf.new_zeros((e * c + 1, d))
            buf.index_copy_(0, dest, xf.index_select(0, sort_idx // k))
            ye = moe_lib._expert_mlp(
                p, buf[r0 * c:(r0 + el) * c].reshape(el, c, d))
            ye = torch.cat([xf.new_zeros((r0 * c, d)), ye.reshape(el * c, d),
                            xf.new_zeros(((e - r0 - el) * c + 1, d))])
            y_assign = ye.index_select(0, slot).reshape(n, k, d)
            out = torch.bmm(gate.to(h.dtype)[:, None, :], y_assign)[:, 0]
        out = out.reshape(b, s, d)
        if "dense" in p:
            out = out + gated_mlp(p["dense"], h)
        return out, aux

    def block_fwd(self, p, x, positions, spec, path, enc=None,
                  moe_impl=None):
        """``blocks.block_fwd`` itself on the rank's shards, its hooks the
        rank's (``RankHooks``). Returns (x, aux)."""
        sp = self.block_specs(spec)
        p = self.shards(p, sp, path)
        for name in ("mixer", "xattn"):
            if "wk" in sp.get(name, {}) and self.layout(sp[name]) == \
                    "repeat":
                # the replicated K/V projections: each rank's gradient is
                # its heads' part
                p = dict(p, **{name: dict(p[name], **{
                    k: self.grad_sum(p[name][k], (f"params:{path}.{name}."
                                                  f"{k}",))
                    for k in ("wk", "wv", "bk", "bv") if k in p[name]})})
        return blk.block_fwd(p, x, positions, self.cfg, spec,
                             enc_memory=enc, moe_impl=moe_impl,
                             hooks=RankHooks(self, sp, path))

    def unit_fwd(self, up, x, positions, specs, stack, enc=None):
        """One unit of ``stack`` ("units", "remainder", "enc_units")."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, spec in enumerate(specs):
            x, a = self.block_fwd(up[str(i)], x, positions, spec,
                                  f"{stack}.{i}", enc)
            aux = aux + a
        return x, aux

    # -- decode -----------------------------------------------------------
    def attn_step(self, p, sp, h, cache, pos, path, cpath, *, mode,
                  window=0):
        """One token of self-attention (or, ``mode`` "cross", attention to
        the cached memory K/V) against the rank's cache shard."""
        cfg = self.cfg
        layout = self.layout(sp)
        w = lambda k: (f"params:{path}.{k}",)
        ck = (f"cache:{cpath}.{'xk' if mode == 'cross' else 'kv.k'}",)
        if mode == "cross":
            q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
            if "bq" in p:
                q = q + p["bq"]
            k_c, v_c = cache["xk"], cache["xv"]
        else:
            q, k1, v1 = attn_lib._project_qkv(p, h, h, cfg)
            k_c, v_c, slot_pos = (cache["kv"][n] for n in
                                  ("k", "v", "slot_pos"))
        whole = lambda t, n, dim: self.gather(t, dim, w(n))
        if layout == "dims":
            q = whole(q, "wq", -1)
        else:
            q = whole(q, "wq", 2)
        dl = k_c.shape[-1]                    # the rank's head_dim slice
        r0 = self.mi * dl
        if mode != "cross":
            if layout == "dims":
                k1, v1 = whole(k1, "wk", -1), whole(v1, "wv", -1)
            elif layout == "heads":
                k1, v1 = whole(k1, "wk", 2), whole(v1, "wv", 2)
            positions = torch.full((h.shape[0], 1), pos, dtype=torch.int64,
                                   device=h.device)
            q = apply_rope(q, positions, cfg.rope_theta)
            k1 = apply_rope(k1, positions, cfg.rope_theta)
            clen = k_c.shape[1]
            slot = torch.full((1,), pos % clen if mode == "local" else pos,
                              dtype=torch.int64, device=h.device)
            k_c.index_copy_(1, slot, k1[..., r0:r0 + dl].to(k_c.dtype))
            v_c.index_copy_(1, slot, v1[..., r0:r0 + dl].to(v_c.dtype))
            slot_pos.index_copy_(0, slot, torch.full(
                (1,), pos, dtype=torch.int32, device=h.device))
        scores = attn_lib._gqa_scores(q[..., r0:r0 + dl], k_c).to(
            torch.float32)
        scores = self.leave(scores, ck) * (cfg.hd ** -0.5)
        if mode != "cross":
            scores = softcap(scores, cfg.attn_softcap)
            valid = (slot_pos >= 0) & (slot_pos <= pos)
            if mode == "local":
                valid &= slot_pos > pos - window
            scores = torch.where(valid, scores, -1e30)
        pr = torch.softmax(scores, dim=-1).to(v_c.dtype)
        out = attn_lib._gqa_out(pr, v_c)                  # (B,1,H,hd/m)
        if layout != "dims":
            hl = p["wo"].shape[0]
            out = self.gather(out, -1, ck)[:, :, self.mi * hl:
                                          (self.mi + 1) * hl]
        return self.leave(torch.einsum("bshk,hkd->bsd", out, p["wo"]),
                          w("wo"))

    def rglru_step(self, p, h, cache, path):
        f32 = torch.float32
        w = lambda k: f"params:{path}.{k}"
        y = rglru_lib.gelu(h @ p["wy"])
        u, conv_state = rglru_lib._causal_conv(p, h @ p["wx"],
                                               cache["conv"])
        uw = self.gather(u, -1, (w("wx"), w("wa")))
        log_a, x_in = rglru_lib._gates(p, u[:, 0], uw[:, 0])
        a = torch.exp(log_a)
        hs = cache["h"].mul_(a).add_(
            torch.sqrt(torch.clamp_min(1 - a * a, 0.0)) * x_in)
        cache["conv"].copy_(conv_state)
        out = self.leave((y[:, 0].to(f32) * hs) @ p["wo"].to(f32), (w("wo"),))
        return out[:, None].to(h.dtype)

    def ssd_step(self, p, h, cache, path, cpath):
        """One token on the rank's heads (its shard of the state)."""
        cfg = self.cfg
        b = h.shape[0]
        di, n, nh, hp = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                         cfg.ssm_head_dim)
        f32 = torch.float32
        hl = cache["h"].shape[1]
        r0 = self.mi * hl
        rows = slice(r0 * hp, (r0 + hl) * hp)
        z, xbc, dt_raw = ssd_lib._split_proj(p, h, cfg)
        xbc, conv_state = ssd_lib._causal_conv(p["conv"], xbc, cache["conv"])
        xbc = xbc[:, 0]
        xs = xbc[..., :di].reshape(b, nh, hp)[:, r0:r0 + hl].to(f32)
        bt = xbc[..., di:di + n].to(f32)
        ct = xbc[..., di + n:].to(f32)
        dt = softplus(dt_raw[:, 0].to(f32) + p["dt_bias"])[:, r0:r0 + hl]
        a = torch.exp(-torch.exp(p["a_log"][r0:r0 + hl]) * dt)
        hs = cache["h"].mul_(a[:, :, None, None]).add_(torch.einsum(
            "bh,bhp,bn->bhpn", dt, xs, bt))
        cache["conv"].copy_(conv_state)
        y = (torch.einsum("bhpn,bn->bhp", hs, ct)
             + p["d_skip"][r0:r0 + hl][:, None] * xs).reshape(b, hl * hp)
        y = y * F.silu(z[:, 0, rows].to(f32))
        ssq = self.leave(torch.sum(torch.square(y), dim=-1, keepdim=True),
                         (f"cache:{cpath}.ssm.h",))
        y = y * torch.rsqrt(ssq / di + 1e-6) * (1.0 + p["norm_z"][rows])
        why = (f"params:{path}.out_proj",)
        return self.leave(y @ p["out_proj"].to(f32), why)[:, None].to(
            h.dtype)

    def block_step(self, p, x, cache, pos, spec, path, cpath):
        """``blocks.block_step`` on the rank's shards; writes the rank's
        cache shard in place."""
        cfg = self.cfg
        sp = self.block_specs(spec)
        p = self.shards(p, sp, path)
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        if spec.mixer == MIXER_RGLRU:
            m = self.rglru_step(p["mixer"], h, cache["rnn"], f"{path}.mixer")
        elif spec.mixer == MIXER_SSD:
            m = self.ssd_step(p["mixer"], h, cache["ssm"], f"{path}.mixer",
                              cpath)
        else:
            m = self.attn_step(
                p["mixer"], sp["mixer"], h, cache, pos, f"{path}.mixer",
                cpath, mode="local" if spec.mixer == MIXER_LOCAL_ATTN
                else "causal", window=cfg.window)
        x = x + m
        if spec.mixer == MIXER_CROSS_ATTN:
            h = rms_norm(x, p["norm_x"], cfg.norm_eps)
            x = x + self.attn_step(p["xattn"], sp["xattn"], h, cache, pos,
                                   f"{path}.xattn", cpath, mode="cross")
        if spec.ffn != FFN_NONE:
            h = rms_norm(x, p["norm2"], cfg.norm_eps)
            if spec.ffn == FFN_MLP:
                x = x + self.mlp(p["ffn"], h, f"{path}.ffn")
            else:
                x = x + self.moe(p["ffn"], h, f"{path}.ffn",
                                 cfg.moe_decode_impl)[0]
        return x

    # -- embedding and head -----------------------------------------------
    def _table(self, p, sp, name):
        """The embedding table (or lm_head) ready for use: an ``fsdp``
        shard gathered over ``data``; split on d_model: gathered whole."""
        t = self.shards({name: p[name]}, {name: sp[name]}, "")[name]
        why = (f"params:{name}",)
        if sp[name][0] != "model":
            t = self.gather(t, 1, why)
        return t

    def embed(self, p, sp, batch):
        """Token embeddings (B,S,d) (and a vision model's patches before
        them): vocab-parallel lookup and all-reduce, or a lookup in the
        gathered table."""
        cfg = self.cfg
        table = self._table(p, sp, "embed")
        tokens = batch["tokens"].long()
        scale = torch.full((), cfg.d_model ** 0.5, dtype=table.dtype,
                           device=table.device)
        if sp["embed"][0] == "model":
            vl = table.shape[0]
            local = tokens - self.mi * vl
            inside = (local >= 0) & (local < vl)
            x = table[local.clamp(0, vl - 1)] * scale
            x = self.leave(x * inside[..., None].to(x.dtype),
                           ("params:embed",))
        else:
            x = table[tokens] * scale
        if cfg.frontend == "vision" and "patches" in batch:
            vp = self.shards({"vis_proj": p["vis_proj"]},
                             {"vis_proj": sp["vis_proj"]}, "")["vis_proj"]
            vis = self.gather(batch["patches"].to(x.dtype) @ vp, -1,
                              ("params:vis_proj",))
            x = torch.cat([vis, x], dim=1)
        return x

    def logits_loss(self, p, sp, x, labels):
        """The mean next-token loss of x (B,S,d) (the text positions of a
        vision model): vocab-parallel cross entropy (the max, the sum of
        exponentials and the target logit all-reduced), or the whole
        logits from the gathered table."""
        cfg = self.cfg
        name = "embed" if cfg.tie_embeddings else "lm_head"
        why = (f"params:{name}",)
        x = rms_norm(x, p["final_norm"], cfg.norm_eps)
        if cfg.frontend == "vision":
            x = x[:, -labels.shape[1]:]
        labels = labels.long()
        if sp[name][0] == "model":
            table = self._table(p, sp, name)
            vl = table.shape[0]
            lg = softcap((self.enter(x, why) @ table.T).to(torch.float32),
                         cfg.logit_softcap)
            mx = self.coll(lg.detach().amax(-1, keepdim=True),
                           fwd=("all_reduce_max", None, ("model",), why))
            se = self.leave(torch.exp(lg - mx).sum(-1), why)
            local = labels - self.mi * vl
            inside = (local >= 0) & (local < vl)
            tgt = torch.gather(lg, -1, local.clamp(0, vl - 1)[..., None])
            tgt = self.leave(tgt[..., 0] * inside, why)
            nll = torch.log(se) + mx[..., 0] - tgt
        else:
            table = self._table(p, sp, name)
            lg = softcap((x @ table.T).to(torch.float32), cfg.logit_softcap)
            nll = -torch.gather(torch.log_softmax(lg, -1), -1,
                                labels.clamp_min(0)[..., None])[..., 0]
        return nll.mean()

    def last_logits(self, p, sp, x):
        """(B, V) logits of x (B,d), gathered whole over ``model`` where
        the vocabulary is split (the step's output is replicated)."""
        cfg = self.cfg
        name = "embed" if cfg.tie_embeddings else "lm_head"
        x = rms_norm(x, p["final_norm"], cfg.norm_eps)
        table = self._table(p, sp, name)
        lg = softcap((x @ table.T).to(torch.float32), cfg.logit_softcap)
        if sp[name][0] == "model":
            lg = self.gather(lg, -1, (f"params:{name}",))
        return lg


class RankHooks:
    """``models/hooks.py``'s hooks as one rank of ``prog`` (a
    ``RankProgram``), for the sub-tree ``path`` of a block whose specs are
    ``sp``: the collectives of the module docstring's rank program, and
    the kernels of ``prog.fns``."""

    def __init__(self, prog: RankProgram, sp, path: str):
        self.prog, self.sp, self.path = prog, sp, path

    def _why(self, *weights) -> tuple:
        return tuple(f"params:{self.path}.{w}" for w in weights)

    def sub(self, name: str) -> "RankHooks":
        return RankHooks(self.prog, self.sp.get(name), f"{self.path}.{name}")

    def enter(self, x, weight: str):
        return self.prog.enter(x, self._why(weight))

    def leave(self, x, weight: str):
        return self.prog.leave(x, self._why(weight))

    def heads(self, q, k, v):
        """Split on head_dim: q, k and v gathered to whole heads. K/V
        replicated: repeated to the rank's query heads."""
        layout = self.prog.layout(self.sp)
        if layout == "dims":
            return tuple(self.prog.gather(t, -1, self._why(n))
                         for t, n in ((q, "wq"), (k, "wk"), (v, "wv")))
        if layout == "repeat":
            cfg = self.prog.cfg
            hl = q.shape[2]
            r0 = self.prog.mi * hl
            k, v = (t.repeat_interleave(cfg.n_heads // cfg.n_kv_heads,
                                        dim=2)[:, :, r0:r0 + hl]
                    for t in (k, v))
        return q, k, v

    def head_out(self, o):
        if self.prog.layout(self.sp) == "dims":
            return self.prog.keep(o, -1, self._why("wo"))
        return o

    def channels(self, u):
        return self.prog.gather(u, -1, self._why("wx", "wa"),
                                bwd="reduce_scatter")

    def keep(self, y, weight: str):
        return self.prog.keep(y, -1, self._why(weight))

    def impl(self, fn):
        if fn.__name__ == "moe_ffn":
            return lambda p, h, cfg, impl: self.prog.moe(p, h, self.path,
                                                         impl)
        return getattr(self.prog.fns, fn.__name__)


# ---------------------------------------------------------------------------
# The reckoning
# ---------------------------------------------------------------------------

def _fake_tree(shapes, requires_grad=False):
    """Tensors of the (shape, dtype) leaves of ``shapes`` (under a fake
    mode: no storage)."""
    def make(sd):
        shape, dt = sd
        t = torch.zeros(shape, dtype=dt)
        return t.requires_grad_(requires_grad and t.is_floating_point())
    if isinstance(shapes, dict):
        return {k: _fake_tree(v, requires_grad) for k, v in shapes.items()}
    return make(shapes)


def _spec_leaves(specs, prefix=""):
    """(path, spec) of every leaf of a spec tree."""
    if isinstance(specs, dict):
        for k in specs:
            yield from _spec_leaves(specs[k], f"{prefix}.{k}" if prefix
                                    else str(k))
    else:
        yield prefix, specs


def share_bytes(tree, specs, mesh) -> int:
    """The bytes of one rank's share of ``tree`` (meta tensors) under
    ``specs``."""
    total = 0
    for (path, spec), t in zip(_spec_leaves(specs), _tree_in_spec_order(
            tree, specs)):
        total += math.prod(local_shape(spec, tuple(t.shape), mesh)) * \
            t.element_size()
    return total


def unit_share_bytes(cfg, mesh) -> dict:
    """The bytes of one rank's shards of one unit of each stack: the
    model's own unit (``blocks.init_unit`` on fake tensors) under the
    whole model's specs (``rules.param_specs``, their stacked axis
    unsplit), a count apart from the shards a share draws
    (``RankProgram.unit_shapes``: ``rules.block_specs`` of
    ``steps.unit_params_specs``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    psp = rules.param_specs(cfg, mesh)
    stacks = {"units": cfg.pattern, "remainder": cfg.remainder,
              "enc_units": cfg.enc_pattern if cfg.is_encdec else ()}
    out = {}
    for stack, specs in stacks.items():
        if not specs:
            continue
        with FakeTensorMode():
            unit = blk.init_unit(torch.Generator(), cfg, specs,
                                 lm._dtype(cfg), "cpu")
        lead = (1,) if stack != "remainder" else ()
        out[stack] = sum(
            math.prod(local_shape(spec, lead + tuple(t.shape), mesh))
            * t.element_size() for (_, spec), t in zip(
                _spec_leaves(psp[stack]),
                _tree_in_spec_order(unit, psp[stack])))
    return out


def _tree_in_spec_order(tree, specs):
    if isinstance(specs, dict):
        for k in specs:
            yield from _tree_in_spec_order(tree[k], specs[k])
    else:
        yield tree


class _Part:
    """A traced part of the step: its FLOPs and collectives (one copy)."""

    def __init__(self, name, count):
        self.name, self.count = name, count
        self.flops = 0.0
        self.records: list = []
        self.calls: list = []


def _trace(part, prog, fn, *, grad):
    """Run ``fn()`` (returns a scalar under ``grad``) under
    ``FlopCounterMode``, its backward too, recording FLOPs, collectives
    and kernel calls into ``part``."""
    from torch.utils.flop_counter import FlopCounterMode
    rec = prog.fns
    n_rec, n_calls, f0 = len(prog.comm.records), len(rec.calls), rec.flops
    with FlopCounterMode(display=False) as fc:
        if grad:
            with torch.enable_grad():
                out, inputs = fn()
                torch.autograd.grad(out, inputs, allow_unused=True)
        else:
            with torch.no_grad():
                fn()
    part.flops += fc.get_total_flops() + rec.flops - f0
    part.records += prog.comm.records[n_rec:]
    part.calls += rec.calls[n_calls:]


def _leaves_requiring_grad(tree):
    return [t for t in tree_leaves(tree) if t.requires_grad]


def _unit_parts(cfg, shape, mesh, bx, prog) -> list:
    """The traced parts of one step: one unit of each stack (counted
    n_units times), the remainder, and the head."""
    b_glob = shape.global_batch
    nb = math.prod(prog.sizes[a] for a in bx)
    b = b_glob // nb
    dt = lm._dtype(cfg)
    d = cfg.d_model
    kind = shape.kind
    parts = []
    stacks = [("units", cfg.pattern, cfg.n_units, True)]
    if cfg.remainder:
        stacks.append(("remainder", cfg.remainder, 1, False))
    if cfg.is_encdec and kind != "decode":
        stacks.append(("enc_units", cfg.enc_pattern, cfg.enc_n_units, True))
    for stack, specs, count, remat in stacks:
        enc_side = stack == "enc_units"
        s = (cfg.enc_frames if enc_side else
             1 if kind == "decode" else shape.seq_len)
        unit_shapes = prog.unit_shapes(specs)
        part = _Part(stack, count)
        if kind == "decode":
            enc_len = cfg.enc_frames if cfg.is_encdec else 0
            cache_glob = blk.init_unit_cache(b_glob, cfg, specs,
                                             shape.seq_len, dt, "meta",
                                             enc_len)
            csp = {str(i): rules.block_cache_spec_for(cfg, mesh, sp, bx)
                   for i, sp in enumerate(specs)}
            cache_shapes = tree_map(lambda t, sp: (local_shape(
                sp, tuple(t.shape), mesh), t.dtype), cache_glob, csp)

            def step(unit_shapes=unit_shapes, cache_shapes=cache_shapes,
                     specs=specs, stack=stack):
                up = _fake_tree(unit_shapes)
                cache = _fake_tree(cache_shapes)
                x = torch.zeros((b, 1, d), dtype=dt)
                for i, sp in enumerate(specs):
                    x = prog.block_step(up[str(i)], x, cache[str(i)],
                                        shape.seq_len - 1, sp,
                                        f"{stack}.{i}", f"{stack}.{i}")
            _trace(part, prog, step, grad=False)
        else:
            def unit(unit_shapes=unit_shapes, specs=specs, stack=stack,
                     s=s, grad=kind == "train"):
                up = _fake_tree(unit_shapes, requires_grad=grad)
                x = torch.zeros((b, s, d), dtype=dt, requires_grad=grad)
                pos = torch.arange(s, dtype=torch.int32).expand(b, s)
                enc = None
                if cfg.is_encdec and stack != "enc_units":
                    enc = torch.zeros((b, cfg.enc_frames, d), dtype=dt,
                                      requires_grad=grad)
                y, aux = prog.unit_fwd(up, x, pos, specs, stack, enc)
                inputs = _leaves_requiring_grad(up) + [x] + (
                    [enc] if enc is not None else [])
                return y.float().sum() + aux, inputs
            _trace(part, prog, unit, grad=kind == "train")
            if kind == "train" and remat:
                again = _Part(stack + "_remat", count)
                _trace(again, prog, lambda: unit(grad=False), grad=False)
                parts.append(again)
        parts.append(part)
    parts.append(_head_part(cfg, shape, mesh, bx, prog, b))
    return parts


def _head_part(cfg, shape, mesh, bx, prog, b):
    """Embedding, final norm, logits (and loss): traced once."""
    psp = rules.param_specs(cfg, mesh)
    glob = steps_lib.params_specs(cfg)
    names = [k for k in ("embed", "lm_head", "final_norm", "vis_proj")
             if k in glob]
    shapes = {k: (local_shape(psp[k], tuple(glob[k].shape), mesh),
                  glob[k].dtype) for k in names}
    sp = {k: psp[k] for k in names}
    part = _Part("head", 1)
    kind = shape.kind
    dt = lm._dtype(cfg)
    batch_glob = (steps_lib.batch_specs(cfg, shape) if kind != "decode"
                  else {"tokens": steps_lib._sds((shape.global_batch, 1),
                                                 torch.int32)})
    s_total = shape.seq_len if kind != "decode" else 1

    def head(grad=kind == "train"):
        p = _fake_tree(shapes, requires_grad=grad)
        batch = {k: torch.zeros((b, *t.shape[1:]), dtype=t.dtype)
                 for k, t in batch_glob.items()}
        if grad and "patches" in batch:
            batch["patches"].requires_grad_(True)
        x = prog.embed(p, sp, batch)
        xf = torch.zeros((b, s_total, cfg.d_model), dtype=dt,
                         requires_grad=grad)
        if kind == "train":
            loss = prog.logits_loss(p, sp, xf, batch["labels"])
            inputs = _leaves_requiring_grad(p) + [xf]
            return loss + x.float().sum(), inputs
        prog.last_logits(p, sp, xf[:, -1])
    _trace(part, prog, head, grad=kind == "train")
    return part


def _grad_sync(cfg, mesh, bx, psp, params) -> list:
    """The gradient all-reduces over the batch axes, leaf by leaf: over
    every batch axis for a shard replicated on them, over ``pod`` for an
    ``fsdp`` shard (its reduce-scatter over ``data`` is the unit's)."""
    sizes = rules.mesh_axis_sizes(mesh)
    out = []
    for (path, spec), t in zip(_spec_leaves(psp),
                               _tree_in_spec_order(params, psp)):
        axes = tuple(a for a in bx if a not in _axes_of(spec))
        if not axes or math.prod(sizes[a] for a in axes) == 1:
            continue
        nbytes = math.prod(local_shape(spec, tuple(t.shape), mesh)) * \
            t.element_size()
        out.append(dict(op="all_reduce", axes=axes, bytes=nbytes,
                        why=(f"params:{path}", "batch:tokens")))
    return out


def reckon_one(arch: str, shape_name: str, mesh, *, optimized=False,
               overrides: dict | None = None) -> dict:
    """One rank's reckoning of ``shape_name``'s step for ``arch`` on
    ``mesh`` (a ``DeviceMesh`` or a plain mesh)."""
    cfg = get_arch(arch, shape_name, optimized=optimized)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return dict(arch=arch, **reckon_cfg(cfg, SHAPES[shape_name], mesh))


def reckon_cfg(cfg, shape, mesh) -> dict:
    """One rank's reckoning of the step of ``shape`` (an ``InputShape``)
    for the configuration ``cfg`` on ``mesh``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.perf_counter()
    args, in_sh, out_sh, _ = steps_lib.input_specs(cfg, shape, mesh)
    bx = steps_lib.step_batch_axes(shape, mesh)
    sizes = rules.mesh_axis_sizes(mesh)
    psp = rules.param_specs(cfg, mesh)
    params = args[0]
    nbytes = {"params": share_bytes(params, psp, mesh)}
    if shape.kind == "train":
        nbytes["grads"] = nbytes["params"]
        nbytes["opt"] = share_bytes(args[1], in_sh[1], mesh)
        nbytes["inputs"] = share_bytes(args[2], in_sh[2], mesh)
    elif shape.kind == "prefill":
        nbytes["inputs"] = share_bytes(args[1], in_sh[1], mesh)
        nbytes["cache"] = share_bytes(_prefill_cache(cfg, shape),
                                      out_sh[1], mesh)
    else:
        nbytes["cache"] = share_bytes(args[1], in_sh[1], mesh)
        nbytes["inputs"] = share_bytes(args[2], in_sh[2], mesh)
    nbytes["total"] = sum(nbytes.values())
    prog = RankProgram(cfg, mesh, bx, KernelRecorder())
    with FakeTensorMode(allow_non_fake_inputs=True):
        parts = _unit_parts(cfg, shape, mesh, bx, prog)
    records = []
    for part in parts:
        records += [dict(r, part=part.name, per_step=part.count)
                    for r in part.records]
    if shape.kind == "train":
        records += [dict(r, part="grad_sync", per_step=1)
                    for r in _grad_sync(cfg, mesh, bx, psp, params)]
    coll: dict = {}
    for r in records:
        rec = coll.setdefault(r["op"], {"bytes": 0, "count": 0})
        rec["bytes"] += r["bytes"] * r["per_step"]
        rec["count"] += r["per_step"]
    unit = next(p for p in parts if p.name == "units")
    return dict(
        shape=shape.name, mesh=mesh_name(mesh),
        kind=shape.kind, config_name=cfg.name, n_ranks=math.prod(
            sizes.values()),
        batch_axes=list(bx),
        local_batch=shape.global_batch // math.prod(sizes[a] for a in bx),
        params=cfg.param_count(), active_params=cfg.active_param_count(),
        n_units=cfg.n_units, enc_n_units=cfg.enc_n_units,
        bytes=nbytes, exceeds_card=nbytes["total"] > CARD_BYTES,
        unit_param_bytes=unit_share_bytes(cfg, mesh),
        flops=sum(p.flops * p.count for p in parts),
        flops_by_part={p.name: p.flops * p.count for p in parts},
        unit_flops=unit.flops,
        collectives=coll,
        collective_bytes=sum(v["bytes"] for v in coll.values()),
        collective_records=records,
        kernel_calls={p.name: p.calls for p in parts if p.calls},
        seconds=time.perf_counter() - t0)


def _prefill_cache(cfg, shape):
    enc_len = cfg.enc_frames if cfg.is_encdec else 0
    return steps_lib.cache_sds(cfg, shape.global_batch, shape.seq_len,
                               enc_len)


def combos(archs=None, shapes=None, meshes=None):
    """(arch, shape, mesh name) in the reference's order, with whether
    ``applicable`` holds."""
    out = []
    for a in archs or sorted(ARCHS):
        for s in shapes or sorted(SHAPES):
            for mn in meshes or list(MESHES):
                out.append((a, s, mn, applicable(a, s)))
    return out


def fake_world(mesh: str):
    """A ``fake``-backend world of the mesh's rank count and its
    ``DeviceMesh`` (destroy with ``dist.destroy_process_group``)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run makes its own fake world: run it "
                           "before init_world or after close_world")
    shape, axes = MESHES[mesh]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    return mesh_lib.make_production_mesh(multi_pod=len(shape) == 3,
                                         device="cpu")


def reckon(todo, *, optimized=False, overrides=None, on_result=None) -> list:
    """The reckoning of every (arch, shape, mesh name) of ``todo``, on a
    fake world per mesh (made here and destroyed at the end)."""
    out = []
    for mn in MESHES:
        mine = [(a, s) for a, s, m in todo if m == mn]
        if not mine:
            continue
        mesh = fake_world(mn)
        try:
            for a, s in mine:
                rec = reckon_one(a, s, mesh, optimized=optimized,
                                 overrides=overrides)
                out.append(rec)
                if on_result is not None:
                    on_result(rec)
        finally:
            dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# The kernels' shape rules
# ---------------------------------------------------------------------------

def unit_plan(cfg, shape, mesh) -> list:
    """The kernel calls of one unit of each stack of ``shape``'s step for
    ``cfg`` on one rank of ``mesh`` (forward, and backward for train),
    traced on fake tensors without counting anything else."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    bx = steps_lib.step_batch_axes(shape, mesh)
    steps_lib.params_specs(cfg)             # the unit trees, outside the mode
    prog = RankProgram(cfg, mesh, bx, KernelRecorder())
    if shape.kind == "decode":
        return []                  # decode's mixers are plain PyTorch
    b = shape.global_batch // math.prod(prog.sizes[a] for a in bx)
    dt = lm._dtype(cfg)
    grad = shape.kind == "train"
    with FakeTensorMode(allow_non_fake_inputs=True), \
            torch.set_grad_enabled(grad):
        for stack, specs in share_stacks(cfg):
            s = cfg.enc_frames if stack == "enc_units" else shape.seq_len
            up = _fake_tree(prog.unit_shapes(specs), requires_grad=grad)
            x = torch.zeros((b, s, cfg.d_model), dtype=dt,
                            requires_grad=grad)
            pos = torch.arange(s, dtype=torch.int32).expand(b, s)
            enc = (torch.zeros((b, cfg.enc_frames, cfg.d_model), dtype=dt,
                               requires_grad=grad)
                   if cfg.is_encdec and stack == "units" else None)
            y, aux = prog.unit_fwd(up, x, pos, specs, stack, enc)
            if grad:
                torch.autograd.grad(y.float().sum() + aux, [x],
                                    allow_unused=True)
    return prog.fns.calls


def _meta_arg(a):
    return torch.empty_strided(a["shape"], a["stride"],
                               dtype=getattr(torch, a["dtype"]),
                               device="meta")


def _tma_strides(t, axes: int) -> bool:
    """TMA's stride rule (16-byte multiples on the outer axes longer than
    1); the address rule needs storage and is the wrapper's to check."""
    return all(st * t.element_size() % 16 == 0 for st, n in
               zip(t.stride()[:axes], t.shape[:axes]) if n > 1)


def check_call(call) -> str:
    """Raise ``ValueError`` unless the kernel wrapper of ``call`` (a plan
    entry) takes its shapes, dtypes and strides on the card, by the
    wrapper's own rules (``check_args``), and, in bf16, by the Hopper
    routes' (TMA strides; the attention backward's Hopper design at its
    head dims; the SSD kernels' P 64, N 128, chunk 128). Returns the route
    the call takes."""
    kernel = call["kernel"]
    args = [_meta_arg(a) for a in call["args"]]
    if kernel.startswith("flash_attention"):
        q, k, v = args[:3]
        fa.check_args(q, k, v, call["window"])
        if q.dtype != torch.bfloat16:
            return "simt"
        if not all(_tma_strides(t, 3) for t in args):
            strides = [a["stride"] for a in call["args"]]
            raise ValueError(f"{kernel}: strides {strides} break the TMA "
                             f"rule")
        if kernel == "flash_attention":
            return "sm90"
        b, h, s, d = q.shape
        plan_ = fa.bwd_plan(b, h, k.shape[1], s, k.shape[2], d,
                            call["causal"], call["window"], q.dtype)
        if plan_.cfg != fa.BWD_SM90:
            raise ValueError(f"{kernel}: head dim {d} is not one of the "
                             f"Hopper design's {fa.BWD_SM90_HEAD_DIMS}")
        return "sm90"
    if kernel.startswith("ssd_scan"):
        x, bt, ct, log_a, dt = args[:5]
        sss.check_args(x, bt, ct, log_a, dt, None, call["chunk"])
        if x.dtype != torch.bfloat16:
            return "simt"
        if not sss.uses_sm90(x.dtype, x.shape[3], bt.shape[2],
                             call["chunk"]):
            raise ValueError(f"{kernel}: P {x.shape[3]}, N {bt.shape[2]}, "
                             f"chunk {call['chunk']} is not the Hopper "
                             f"kernels' {sss.SM90_TILE}")
        if not (_tma_strides(x, 3) and _tma_strides(bt, 2)
                and _tma_strides(ct, 2)):
            raise ValueError(f"{kernel}: x / B / C strides break the TMA "
                             f"rule")
        return "sm90"
    log_a, x_in = args[:2]
    more = [(n, t, tuple(x_in.shape)) for n, t in zip(("h", "dh"),
                                                      args[2:])]
    rgs.check_args(log_a, x_in, None, *more)
    return "sm90" if x_in.shape[-1] % 4 == 0 else "simt"


def check_plan(calls) -> list:
    """``check_call`` of every call; returns their routes."""
    return [check_call(c) for c in calls]


# ---------------------------------------------------------------------------
# One rank's share on the card
# ---------------------------------------------------------------------------

# the shares timed on the card: train_4k on 16 x 16 (local batch 16,
# S 4096), one unit forward and backward (seamless: one decoder and one
# encoder unit), collectives left out
SHARES = ("granite-3-2b", "seamless-m4t-medium", "mamba2-1.3b",
          "recurrentgemma-9b")
SHARE_SHAPE = "train_4k"
SHARE_MESH = "16x16"


def share_stacks(cfg) -> list:
    """(stack, specs) of the units a share runs."""
    out = [("units", cfg.pattern)]
    if cfg.is_encdec:
        out.append(("enc_units", cfg.enc_pattern))
    return out


def plan(rec: dict) -> list:
    """The kernel calls of a reckoning's share (one unit of each of
    ``share_stacks``, forward and backward): its ``units`` and
    ``enc_units`` parts' calls."""
    return [c for part in ("units", "enc_units")
            for c in rec["kernel_calls"].get(part, [])]


def plan_launches(calls: list) -> dict:
    """The launches a plan implies, by ``kernels.WRAPPERS`` name."""
    out: dict = {}
    for c in calls:
        out[c["kernel"]] = out.get(c["kernel"], 0) + 1
    return out


def share_config(arch: str, dtype=None):
    """The configuration a share of ``arch`` runs (``dtype`` overrides the
    weights' type)."""
    cfg = get_arch(arch, SHARE_SHAPE)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def build_share(arch: str, device, *, seed: int = 0, batch=None, seq=None,
                dtype=None):
    """One rank's share of ``arch``'s train_4k step as tensors on
    ``device``: returns (run, params, inputs), where ``run(plain=False)``
    runs one unit of each stack of ``share_stacks`` forward and backward
    (the unit's input and every parameter shard require grad), on the
    kernel wrappers or, with ``plain``, their plain versions, and returns
    (outputs, gradients). ``batch`` / ``seq`` / ``dtype`` shrink the share
    (the card tests)."""
    shape = SHAPES[SHARE_SHAPE]
    mesh = plain_mesh(SHARE_MESH)
    cfg = share_config(arch, dtype)
    dev = resolve_device(device)
    bx = steps_lib.step_batch_axes(shape, mesh)
    progs = {p: RankProgram(cfg, mesh, bx, KernelFns(plain=p))
             for p in (False, True)}
    prog = progs[False]
    b = batch or shape.global_batch // math.prod(prog.sizes[a] for a in bx)
    s = seq or shape.seq_len
    t = cfg.enc_frames if seq is None else max(16, seq // 4)
    # drawn on the device: a share's activations are 10^8 elements
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = lm._dtype(cfg)

    def rnd(shape_, dt_, scale=1.0):
        return (scale * torch.randn(shape_, generator=gen, device=dev)).to(
            dt_)

    def make(sd, glob, name):
        """A shard drawn at the whole weight's scale: 1/sqrt(fan-in) (the
        dims it contracts over: d_model for the q / k / v projections, the
        last but one for a stacked expert), 0.1 for vectors and biases."""
        shape_, dt_ = sd
        g = tuple(glob.shape)
        if len(g) == 1 or name.startswith("b"):
            std = 0.1
        elif name in ("wq", "wk", "wv") or len(g) == 2:
            std = g[0] ** -0.5
        elif name == "wo":
            std = (g[0] * g[1]) ** -0.5
        else:                                     # (E, in, out) experts
            std = g[1] ** -0.5
        return rnd(shape_, dt_, std).requires_grad_(True)

    def draw(shapes, glob):
        return {k: draw(v, glob[k]) if isinstance(v, dict)
                else make(v, glob[k], k) for k, v in shapes.items()}
    params = {stack: draw(prog.unit_shapes(specs),
                          steps_lib.unit_params_specs(cfg, specs))
              for stack, specs in share_stacks(cfg)}
    x = rnd((b, s, cfg.d_model), dt).requires_grad_(True)
    xe = rnd((b, t, cfg.d_model), dt).requires_grad_(True)
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    pos_e = torch.arange(t, dtype=torch.int32, device=dev).expand(b, t)
    g_out = rnd((b, s, cfg.d_model), dt)

    def run(plain=False):
        prog = progs[plain]
        with torch.enable_grad():
            enc = None
            outs = []
            if "enc_units" in params:
                enc, _ = prog.unit_fwd(params["enc_units"], xe, pos_e,
                                       cfg.enc_pattern, "enc_units")
                outs.append(enc)
            y, aux = prog.unit_fwd(params["units"], x, pos, cfg.pattern,
                                   "units", enc)
            outs.append(y)
            leaves = [l for st in params.values() for l in tree_leaves(st)]
            inputs = leaves + [x] + ([xe] if enc is not None else [])
            ys, gs = [y], [g_out]
            if aux.requires_grad:
                ys.append(aux)
                gs.append(torch.ones_like(aux))
            grads = torch.autograd.grad(ys, inputs, gs, allow_unused=True)
        return [o.detach() for o in outs], list(grads)
    return run, params, dict(x=x, enc_frames=xe)


def compare_share(run) -> dict:
    """A share's ``run`` (``build_share``) on the kernels against the same
    on the plain versions: the largest error of its outputs and of its
    gradients, each relative to that tensor's largest plain magnitude,
    and whether every kernel value is finite."""
    outs, grads = run()
    p_outs, p_grads = run(plain=True)
    out = dict(finite=True, out_rel_err=0.0, grad_rel_err=0.0)
    for key, got, want in (("out_rel_err", outs, p_outs),
                           ("grad_rel_err", grads, p_grads)):
        for a, w in zip(got, want, strict=True):
            if a is None or w is None:
                if (a is None) != (w is None):
                    raise ValueError("a gradient is None on one side only")
                continue
            a, w = a.float(), w.float()
            out["finite"] &= bool(torch.isfinite(a).all())
            top = float(w.abs().max())
            err = float((a - w).abs().max())
            out[key] = max(out[key], err / max(top, 1e-30))
    return out


# each kernel's profiler names (substrings)
KERNEL_NAMES = {"flash_attention": ("flash_attention_kernel",),
                "flash_attention_bwd": ("bwd_q_kernel", "bwd_kv_kernel",
                                        "bwd_reduce_kernel", "delta_kernel"),
                "ssd_scan": ("ssd_kernel",),
                "ssd_scan_bwd": ("ssd_bwd_",),
                "rglru_scan": ("rglru_kernel",),
                "rglru_scan_bwd": ("rglru_bwd_kernel",)}


def kernel_of(name: str):
    """The wrapper a profiled kernel name belongs to (backward names
    first: ``rglru_bwd_kernel`` also holds ``rglru``), or None."""
    for wrapper in ("flash_attention_bwd", "ssd_scan_bwd", "rglru_scan_bwd",
                    "flash_attention", "ssd_scan", "rglru_scan"):
        if any(s in name for s in KERNEL_NAMES[wrapper]):
            return wrapper
    return None


def time_shares(records: dict, device=None, seed: int = 0) -> list:
    """One rank's share of each of ``SHARES`` timed on the card: the
    launches of one call (``kernels.launch_counts``) beside the plan's,
    device ms by kernel and by wrapper, peak memory, the shards' bytes
    beside the reckoning's (``unit_share_bytes``), and the share against
    itself on the plain versions (``compare_share``: ``plain``).
    ``records``: the reckoning of each share's arch at ``SHARE_SHAPE`` on
    ``SHARE_MESH``, by arch."""
    from repro_torch import kernels
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("time_shares times the card: pass a CUDA device")
    out = []
    for arch in SHARES:
        rec = records[arch]
        calls = plan(rec)
        run, params, _ = build_share(arch, dev, seed=seed)
        kernels.reset_launch_counts()
        run()
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        timed = profiling.timed(run, calls=3)
        by_wrapper: dict = {}
        for k, ms in timed["device_ms_by_kernel"].items():
            w = kernel_of(k)
            if w is not None:
                by_wrapper[w] = by_wrapper.get(w, 0.0) + ms
        param_bytes = {st: sum(_nbytes(t) for t in tree_leaves(p))
                       for st, p in params.items()}
        plain = compare_share(run)
        out.append(dict(
            arch=arch, shape=SHARE_SHAPE, mesh=SHARE_MESH,
            local_batch=rec["local_batch"], launches=launches,
            plan_launches=plan_launches(calls), plan=calls,
            kernel_device_ms=by_wrapper, param_bytes=param_bytes,
            reckoned_param_bytes={st: rec["unit_param_bytes"][st]
                                  for st in param_bytes},
            plain=plain, **timed))
        del run, params
        torch.cuda.empty_cache()
    return out


def reckon_shares() -> dict:
    """The reckoning of each share's arch at ``SHARE_SHAPE`` on
    ``SHARE_MESH`` (a fake world), by arch."""
    return {r["arch"]: r for r in reckon([(a, SHARE_SHAPE, SHARE_MESH)
                                           for a in SHARES])}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _summary(rec) -> str:
    return (f"[dryrun] {rec['arch']} x {rec['shape']} x {rec['mesh']}: "
            f"flops/rank={rec['flops']:.3e} "
            f"bytes/rank={rec['bytes']['total']:.3e} "
            f"coll/rank={rec['collective_bytes']:.3e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--unroll", action="store_true",
                    help="accepted for the reference's CLI; changes nothing "
                         "(it steers XLA's cost model, and nothing is "
                         "lowered here)")
    ap.add_argument("--no-probes", dest="probes", action="store_false",
                    help="accepted for the reference's CLI; changes nothing "
                         "(the reckoning is the per-unit probe)")
    ap.add_argument("--resume", action="store_true",
                    help="skip combos already present in --out")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the per-arch optimized settings "
                         "(configs.OPTIMIZED_OVERRIDES)")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="config override, e.g. --set gqa_impl=repeat")
    args = ap.parse_args(argv)
    ov = {}
    for kv in args.overrides:
        k, v = kv.split("=", 1)
        ov[k] = int(v) if v.lstrip("-").isdigit() else v
    meshes = [m for m, multi in (("16x16", False), ("2x16x16", True))
              if not (multi and args.single_pod_only)
              and not (not multi and args.multi_pod_only)]
    if not (args.all or args.arch or args.shape):
        ap.error("name --arch and/or --shape, or --all")
    todo = combos([args.arch] if args.arch else None,
                  [args.shape] if args.shape else None, meshes)
    results, skips, failures = [], [], []
    done = set()
    if args.out and args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            prev = json.load(f)
        results, skips = prev.get("results", []), prev.get("skips", [])
        done = {(r["arch"], r["shape"], r["mesh"]) for r in results}
        done |= {(r["arch"], r["shape"], "-") for r in skips}
        print(f"[dryrun] resuming: {len(results)} done, {len(skips)} "
              f"skipped")

    def flush():
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"results": results, "skips": skips,
                           "failures": failures}, f, indent=1)

    run = []
    for a, s, mn, ok in todo:
        if not ok:
            if (a, s, "-") not in done:
                skips.append({"arch": a, "shape": s,
                              "reason": "full-attention arch; long_500k "
                                        "requires sub-quadratic decode"})
                done.add((a, s, "-"))
                print(f"[dryrun] SKIP {a} x {s} (full attention, noted)")
            continue
        if (a, s, mn) not in done:
            run.append((a, s, mn))

    def keep(rec):
        # the per-collective records and kernel calls stay in memory: the
        # file keeps the totals by operation
        rec = {k: v for k, v in rec.items()
               if k not in ("collective_records", "kernel_calls")}
        results.append(rec)
        print(_summary(rec))
        flush()
    for mn in MESHES:
        for a, s, m in run:
            if m != mn:
                continue
            try:
                reckon([(a, s, m)], optimized=args.optimized,
                       overrides=ov or None, on_result=keep)
            except Exception as e:                      # noqa: BLE001
                failures.append({"arch": a, "shape": s, "mesh": m,
                                 "error": repr(e)[:500]})
                print(f"[dryrun] FAIL {a} x {s} x {m}: {e!r}")
                flush()
    print(f"\n[dryrun] done: {len(results)} ok, {len(skips)} skipped, "
          f"{len(failures)} failed")
    flush()
    if args.out:
        print(f"[dryrun] wrote {args.out}")
    if failures:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
