"""The LM half of the mesh work: ``sharding/rules.py``, the input specs of
``launch/steps.py`` and the dry-run's rank program and reckoning
(``launch/dryrun.py``), held against the reference on the CPU.

The reference's rules and ``steps.input_specs`` read only ``dict(
mesh.shape)`` and ``mesh.axis_names``, so both packages get the production
meshes as plain objects (no ``AbstractMesh``, whose signature differs
between JAX versions). Contracts: the spec trees equal the reference's
leaf for leaf for all ten architectures on both meshes (and under the
optimized settings' repeat-KV layout); ``input_specs``' shapes and dtypes
equal the reference's ``eval_shape`` trees for every (arch, shape, mesh)
where the dry-run applies, and every sharded dimension of the port's
divides; the rank program computes the model: on one rank exactly the
model's unit, and on worlds of 2 and 4 ranks (threads exchanging
tensors for the collectives) each rank's outputs, gradients and cache
shards are its share of the unsharded unit's; the reckoning's FLOPs equal
a hand count; every collective traces back to a spec; and every kernel
call of every (arch, shape, mesh)'s share meets its wrapper's shape rules
(the guard against launching a kernel at a head dim it refuses).
"""
import dataclasses
import math
import threading
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_arch as ref_get_arch
from repro.launch import steps as ref_steps
from repro.sharding import rules as ref_rules
from repro_torch.configs import ARCHS, SHAPES, InputShape, get_arch
from repro_torch.launch import dryrun as dr
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import blocks as blk
from repro_torch.models import lm
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.sharding import rules
from repro_torch.sharding.routing_rules import P, local_shape

torch.set_num_threads(2)
MESH_NAMES = ("16x16", "2x16x16")


def flat(tree, prefix=""):
    """{path: leaf} of nested dicts, tuples and lists; anything else
    (a PartitionSpec, a P, a tensor, a ShapeDtypeStruct) is a leaf."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}.{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P) \
            and type(tree).__name__ != "PartitionSpec":
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def _entry(e):
    """A spec entry in one form: a 1-tuple of axes is its axis and an empty
    tuple None (the same sharding; JAX versions normalise them apart)."""
    if isinstance(e, (list, tuple)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


def sorted_paths(tree, prefix=""):
    """[(path, leaf)] of a dict tree in ``tree_leaves`` order (keys
    sorted)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in sorted_paths(
            tree[k], f"{prefix}.{k}" if prefix else str(k))]
    return [(prefix, tree)]


def spec_tuple(p):
    return tuple(_entry(e) for e in p)


def same_specs(port, ref):
    fp = {k: spec_tuple(v) for k, v in flat(port).items()}
    fr = {k: spec_tuple(v) for k, v in flat(ref).items()}
    assert fp == fr


def combos():
    return [(a, s, m) for a, s, m, ok in dr.combos() if ok]


# ---------------------------------------------------------------------------
# Spec trees and input specs against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optimized", [False, True])
@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_spec_trees_match_reference(arch, mesh_name, optimized):
    mesh = dr.plain_mesh(mesh_name)
    cfg = get_arch(arch, "train_4k", optimized=optimized)
    rcfg = ref_get_arch(arch, "train_4k", optimized=optimized)
    assert cfg.gqa_impl == rcfg.gqa_impl
    psp = rules.param_specs(cfg, mesh)
    same_specs(psp, ref_rules.param_specs(rcfg, mesh))
    same_specs(rules.opt_state_specs(psp),
               ref_rules.opt_state_specs(ref_rules.param_specs(rcfg, mesh)))
    for kind in ("train", "prefill"):
        same_specs(rules.batch_specs(cfg, mesh, kind),
                   ref_rules.batch_specs(rcfg, mesh, kind))
    for bx in (None, ()):
        same_specs(rules.cache_specs(cfg, mesh, bx=bx),
                   ref_rules.cache_specs(rcfg, mesh, bx=bx))
        same_specs(rules.cache_specs(cfg, mesh, stacked=False, bx=bx),
                   ref_rules.cache_specs(rcfg, mesh, stacked=False, bx=bx))
    assert rules.batch_axes(mesh) == ref_rules.batch_axes(mesh)
    assert rules.mesh_axis_sizes(mesh) == ref_rules.mesh_axis_sizes(mesh)


def _shape_dtype(leaf):
    return tuple(int(x) for x in leaf.shape), str(leaf.dtype).replace(
        "torch.", "")


@pytest.mark.parametrize("arch,shape_name,mesh_name", combos())
def test_input_specs_match_reference(arch, shape_name, mesh_name):
    mesh = dr.plain_mesh(mesh_name)
    cfg = get_arch(arch, shape_name)
    args, in_sh, out_sh, step = steps.input_specs(cfg, SHAPES[shape_name],
                                                  mesh)
    rargs, rin, rout, _ = ref_steps.input_specs(
        ref_get_arch(arch, shape_name), REF_SHAPES[shape_name], mesh)
    assert callable(step) and len(args) == len(rargs)
    for a, r in zip(args, rargs):
        fa = {k: _shape_dtype(v) for k, v in flat(a).items()}
        fr = {k: _shape_dtype(v) for k, v in flat(r).items()}
        assert fa == fr
        assert all(v.device.type == "meta" for v in flat(a).values())
    same_specs(in_sh, rin)
    same_specs(out_sh, rout)
    # every dimension the port's specs split divides (local_shape raises)
    for a, sp in zip(args, in_sh):
        fa, fs = flat(a), flat(sp)
        for k, leaf in fa.items():
            local = local_shape(fs[k], tuple(leaf.shape), mesh)
            assert len(local) == leaf.dim()


def test_params_specs_equal_the_models_own_tree():
    """The reckoned parameter tree is ``lm.init_params``' (run under a
    fake mode), for every stack kind."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    for arch in ("recurrentgemma-9b", "seamless-m4t-medium",
                 "llava-next-34b", "arctic-480b"):
        cfg = ARCHS[arch].reduced()
        with FakeTensorMode():
            real = lm.init_params(torch.Generator(), cfg, device="cpu")
        got = steps.params_specs(cfg)
        assert ({k: _shape_dtype(v) for k, v in flat(got).items()}
                == {k: _shape_dtype(v) for k, v in flat(real).items()})


def test_rules_read_a_device_mesh_as_a_plain_mesh():
    """The rules give the same trees on a ``DeviceMesh`` over a fake world
    of 512 as on the plain object."""
    mesh = dr.fake_world("2x16x16")
    try:
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        plain = dr.plain_mesh("2x16x16")
        for arch in ("granite-3-2b", "arctic-480b"):
            cfg = ARCHS[arch]
            same_specs(rules.param_specs(cfg, mesh),
                       rules.param_specs(cfg, plain))
            same_specs(rules.cache_specs(cfg, mesh),
                       rules.cache_specs(cfg, plain))
        assert steps.step_batch_axes(SHAPES["long_500k"], mesh) == ()
        assert steps.step_batch_axes(SHAPES["train_4k"], mesh) == (
            "pod", "data")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The rank program computes the model
# ---------------------------------------------------------------------------

def _mesh(sizes):
    return types.SimpleNamespace(shape=dict(sizes),
                                 axis_names=tuple(sizes))


class ThreadWorld:
    """Ranks as threads; a collective waits for its group's tensors."""

    def __init__(self, sizes):
        self.sizes = dict(sizes)
        self.cv = threading.Condition()
        self.slots: dict = {}


class ThreadComm(dr.Comm):
    def __init__(self, world, coords):
        super().__init__(world.sizes)
        self.world, self.coords = world, dict(coords)
        self.seq: dict = {}

    def index(self, axes):
        i = 0
        for a in axes:
            i = i * self.sizes[a] + self.coords[a]
        return i

    def exchange(self, kind, x, dim, axes):
        group = tuple(self.coords[a] for a in self.sizes if a not in axes)
        key = (group, tuple(axes))
        n = self.seq.get(key, 0)
        self.seq[key] = n + 1
        with self.world.cv:
            slot = self.world.slots.setdefault(key + (n,), {})
            slot[self.index(axes)] = x.detach().clone()
            self.world.cv.notify_all()
            assert self.world.cv.wait_for(
                lambda: len(slot) == self.n(axes), timeout=60)
            parts = [slot[i] for i in range(self.n(axes))]
        if kind == "all_gather":
            return torch.cat(parts, dim=dim)
        if kind == "all_reduce_max":
            return torch.stack(parts).amax(0)
        total = parts[0]
        for t in parts[1:]:
            total = total + t
        if kind == "all_reduce":
            return total
        size = x.shape[dim] // self.n(axes)
        return total.narrow(dim, self.index(axes) * size, size).contiguous()


def run_ranks(sizes, fn):
    """``fn(comm)`` on every rank of a thread world; results by coords."""
    world = ThreadWorld(sizes)
    axes = list(sizes)
    coords = [dict(zip(axes, c)) for c in np.ndindex(*sizes.values())]
    out, errors = {}, []

    def main(c):
        try:
            out[tuple(c.values())] = fn(ThreadComm(world, c))
        except BaseException as e:          # noqa: BLE001
            errors.append(e)
            with world.cv:
                world.cv.notify_all()
    threads = [threading.Thread(target=main, args=(c,)) for c in coords]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if errors:
        raise errors[0]
    return out


def shard(t, spec, comm):
    """The rank's share of the whole tensor ``t`` under ``spec``."""
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n = comm.n(axes)
        size = t.shape[i] // n
        t = t.narrow(i, comm.index(axes) * size, size)
    return t.contiguous()


def small_config(arch, layout="dims", **over):
    """A reduced fp32 configuration with a chosen attention layout on a
    model axis of 2: "dims" (KV 1), "heads" (H 4, KV 2) or "repeat"."""
    cfg = ARCHS[arch].reduced(d_model=64, vocab=96)
    kv = {"dims": 1, "heads": 2, "repeat": 1}[layout]
    cfg = dataclasses.replace(cfg, n_heads=4, n_kv_heads=kv, head_dim=16,
                              d_ff=128 if cfg.d_ff else 0,
                              gqa_impl="repeat" if layout == "repeat"
                              else "grouped", enc_frames=min(
                                  cfg.enc_frames, 12), **over)
    return cfg


def _inputs(cfg, b, s, gen):
    x = 0.5 * torch.randn((b, s, cfg.d_model), generator=gen)
    enc = 0.5 * torch.randn((b, cfg.enc_frames or 1, cfg.d_model),
                            generator=gen)
    g = torch.randn((b, s, cfg.d_model), generator=gen)
    return x, enc, g


def _unit_params(cfg, specs, gen):
    up = blk.init_unit(gen, cfg, specs, torch.float32, "cpu")
    # non-zero norm gains and biases, so every gradient is tested
    return tree_map(lambda t: 0.1 * torch.randn(t.shape, generator=gen)
                    if not t.any() else t, up)


def _close(got, want, what, tol=2e-5):
    top = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= tol * max(top, 1e-6), f"{what}: off by {err} (max {top})"


def check_unit_train(cfg, sizes, specs, stack="units", b=4, s=12, seed=0):
    """One unit forward and backward on every rank of ``sizes`` against
    the unsharded unit: each rank's output rows, input gradient rows and
    gradient shards (summed over the batch ranks, as the gradient sync
    does)."""
    gen = torch.Generator().manual_seed(seed)
    up = _unit_params(cfg, specs, gen)
    x, enc, g = _inputs(cfg, b, s, gen)
    if not cfg.is_encdec or stack != "units":
        enc = None
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    leaves = [t.requires_grad_(True) for t in tree_leaves(up)]
    xr = x.clone().requires_grad_(True)
    er = None if enc is None else enc.clone().requires_grad_(True)
    y, aux = lm._unit_fwd(up, xr, pos, cfg, specs, er)
    want = torch.autograd.grad([y, aux] if aux.requires_grad else [y],
                               leaves + [xr] + ([er] if er is not None
                                                else []),
                               [g, torch.ones(())] if aux.requires_grad
                               else [g], allow_unused=True)
    mesh = _mesh(sizes)
    bx = rules.batch_axes(mesh)

    def rank(comm):
        prog = dr.RankProgram(cfg, mesh, bx, dr.KernelFns(), comm=comm)
        usp = prog.unit_specs(specs)
        lp = tree_map(lambda t, sp: shard(t.detach(), sp, comm)
                      .requires_grad_(True), up, usp)
        rows = lambda t: shard(t, P(bx), comm)
        xl = rows(x).requires_grad_(True)
        el = None if enc is None else rows(enc).requires_grad_(True)
        yl, al = prog.unit_fwd(lp, xl, rows(pos), specs, stack, el)
        ins = tree_leaves(lp) + [xl] + ([el] if el is not None else [])
        got = torch.autograd.grad(
            [yl, al] if al.requires_grad else [yl], ins,
            [rows(g), torch.ones(())] if al.requires_grad else [rows(g)],
            allow_unused=True)
        return yl.detach(), got, usp, comm
    out = run_ranks(sizes, rank)
    names = [n for n, _ in sorted_paths(up)]
    sums = {}
    for coords, (yl, got, usp, comm) in out.items():
        rows = lambda t: shard(t, P(bx), comm)
        _close(yl, rows(y.detach()), f"{coords} y")
        n_p = len(names)
        _close(got[n_p], rows(want[n_p]), f"{coords} dx")
        if enc is not None:
            _close(got[n_p + 1], rows(want[n_p + 1]), f"{coords} denc")
        for i, (name, (_, spec)) in enumerate(zip(names,
                                                  sorted_paths(usp))):
            key = (name, tuple(comm.index((a,)) for a in sizes
                               if a in dr._axes_of(spec)))
            gi = torch.zeros(()) if got[i] is None else got[i]
            sums[key] = sums.get(key, 0) + gi
    for coords, (_, _, usp, comm) in out.items():
        for i, (name, (_, spec)) in enumerate(zip(names,
                                                  sorted_paths(usp))):
            key = (name, tuple(comm.index((a,)) for a in sizes
                               if a in dr._axes_of(spec)))
            w = torch.zeros(()) if want[i] is None else want[i]
            # a gradient shard summed over the ranks it is replicated on
            # (each batch rank's part; every model rank holds the same)
            rep = math.prod(sizes[a] for a in sizes
                            if a not in dr._axes_of(spec) and a not in bx)
            _close(sums[key] / rep, shard(w, spec, comm),
                   f"{coords} d{name}")


@pytest.mark.parametrize("arch,layout", [
    ("granite-3-2b", "dims"), ("granite-3-2b", "heads"),
    ("gemma2-9b", "repeat"), ("qwen2-7b", "dims"),
    ("recurrentgemma-9b", "dims"), ("mamba2-1.3b", "dims"),
    ("granite-moe-3b-a800m", "dims"), ("arctic-480b", "heads"),
    ("seamless-m4t-medium", "heads"), ("seamless-m4t-medium", "dims")])
def test_rank_program_trains_like_the_unit_on_two_ranks(arch, layout):
    """Model axis 2: outputs, input gradients and every gradient shard."""
    over = {}
    if arch == "granite-moe-3b-a800m":
        over = dict(n_experts=3)               # the expert d_ff split
    cfg = small_config(arch, layout, **over)
    check_unit_train(cfg, {"data": 1, "model": 2}, cfg.pattern)
    if cfg.is_encdec:
        check_unit_train(cfg, {"data": 1, "model": 2}, cfg.enc_pattern,
                         stack="enc_units")


@pytest.mark.parametrize("arch", ["mistral-large-123b", "llava-next-34b",
                                  "recurrentgemma-9b"])
def test_rank_program_trains_like_the_unit_on_four_ranks(arch):
    """Data 2 x model 2 with the ``fsdp`` gathers (and their
    reduce-scatters) for the fsdp archs: each rank's rows."""
    cfg = small_config(arch, "dims", fsdp=ARCHS[arch].fsdp)
    check_unit_train(cfg, {"data": 2, "model": 2}, cfg.pattern)


def test_rank_program_is_the_unit_on_one_rank():
    """Axes of size 1: no collective, and the unit's output bitwise."""
    for arch in sorted(ARCHS):
        cfg = ARCHS[arch].reduced(d_model=64, vocab=96)
        gen = torch.Generator().manual_seed(1)
        up = blk.init_unit(gen, cfg, cfg.pattern, torch.float32, "cpu")
        x, enc, _ = _inputs(cfg, 2, 8, gen)
        enc = enc if cfg.is_encdec else None
        pos = torch.arange(8, dtype=torch.int32).expand(2, 8)
        with torch.no_grad():
            want, _ = lm._unit_fwd(up, x, pos, cfg, cfg.pattern, enc)
            mesh = _mesh({"data": 1, "model": 1})
            prog = dr.RankProgram(cfg, mesh, ("data",), dr.KernelFns())
            got, _ = prog.unit_fwd(up, x, pos, cfg.pattern, "units", enc)
        assert torch.equal(got, want), arch
        assert prog.comm.records == []


def _fill_cache(cache, gen, filled):
    for k, v in cache.items():
        if isinstance(v, dict):
            _fill_cache(v, gen, filled)
        elif k == "slot_pos":
            v[:filled] = torch.arange(filled, dtype=torch.int32)
        else:
            v.copy_(0.5 * torch.randn(v.shape, generator=gen))


@pytest.mark.parametrize("arch,layout", [
    ("granite-3-2b", "dims"), ("granite-3-2b", "heads"),
    ("gemma2-9b", "dims"), ("recurrentgemma-9b", "dims"),
    ("mamba2-1.3b", "dims"), ("arctic-480b", "heads"),
    ("seamless-m4t-medium", "heads")])
def test_rank_program_decodes_like_the_unit(arch, layout):
    """One decode token of a unit on every rank of data 2 x model 2
    against ``blocks.block_step``: the output rows and every cache
    shard."""
    cfg = small_config(arch, layout)
    b, t, pos = 4, 16, 9
    gen = torch.Generator().manual_seed(2)
    up = _unit_params(cfg, cfg.pattern, gen)
    cache = blk.init_unit_cache(b, cfg, cfg.pattern, t, torch.float32, "cpu",
                                cfg.enc_frames if cfg.is_encdec else 0)
    _fill_cache(cache, gen, pos)
    x = 0.5 * torch.randn((b, 1, cfg.d_model), generator=gen)
    ref_cache = tree_map(torch.clone, cache)
    y = x
    with torch.no_grad():
        for i, spec in enumerate(cfg.pattern):
            y, _ = blk.block_step(up[str(i)], y, ref_cache[str(i)], pos, cfg,
                                  spec)
    sizes = {"data": 2, "model": 2}
    mesh = _mesh(sizes)
    bx = rules.batch_axes(mesh)

    def rank(comm):
        prog = dr.RankProgram(cfg, mesh, bx, dr.KernelFns(), comm=comm)
        usp = prog.unit_specs(cfg.pattern)
        csp = {str(i): rules.block_cache_spec_for(cfg, mesh, sp, bx)
               for i, sp in enumerate(cfg.pattern)}
        lp = tree_map(lambda w, sp: shard(w, sp, comm), up, usp)
        lc = tree_map(lambda c, sp: shard(c, sp, comm).clone(), cache, csp)
        xl = shard(x, P(bx), comm)
        with torch.no_grad():
            for i, spec in enumerate(cfg.pattern):
                xl = prog.block_step(lp[str(i)], xl, lc[str(i)], pos, spec,
                                     f"units.{i}", f"units.{i}")
        return xl, lc, csp, comm
    for coords, (xl, lc, csp, comm) in run_ranks(sizes, rank).items():
        _close(xl, shard(y, P(bx), comm), f"{coords} x")
        want = tree_map(lambda c, sp: shard(c, sp, comm), ref_cache, csp)
        for (k, a), w in zip(flat(lc).items(), flat(want).values()):
            _close(a.float(), w.float(), f"{coords} cache {k}")


@pytest.mark.parametrize("arch,vocab", [("granite-3-2b", 96),
                                        ("granite-3-2b", 95),
                                        ("llava-next-34b", 96)])
def test_rank_program_head_is_the_models(arch, vocab):
    """The embedding (vocab-split, or d_model-split when the vocabulary
    does not divide) and the loss on data 2 x model 2: every rank's loss
    is its rows' mean next-token loss, its table gradient its share."""
    cfg = dataclasses.replace(small_config(arch, "dims"), vocab_size=vocab)
    if cfg.frontend == "vision":
        cfg = dataclasses.replace(cfg, fsdp=True, n_frontend_tokens=4)
    gen = torch.Generator().manual_seed(3)
    b, s = 4, 10
    params = lm.init_params(gen, cfg, device="cpu")
    names = [k for k in ("embed", "lm_head", "final_norm", "vis_proj")
             if k in params]
    p = {k: params[k] for k in names}
    tokens = torch.randint(0, vocab, (b, s - cfg.n_frontend_tokens),
                           generator=gen, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    if cfg.frontend == "vision":
        batch["patches"] = torch.randn((b, cfg.n_frontend_tokens,
                                        cfg.d_model), generator=gen)
    xf = torch.randn((b, s, cfg.d_model), generator=gen)
    sizes = {"data": 2, "model": 2}
    mesh = _mesh(sizes)
    bx = rules.batch_axes(mesh)
    psp = rules.param_specs(cfg, mesh)

    def ref_rows(rows):
        pr = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        sub = {k: v[rows] for k, v in batch.items()}
        x, _ = lm._embed_inputs(dict(params, **pr), sub, cfg)
        logits = lm._logits(dict(params, **pr), xf[rows], cfg)
        lab = sub["labels"].long()
        logits = logits[:, -lab.shape[1]:]
        nll = -torch.gather(torch.log_softmax(logits, -1), -1,
                            lab[..., None])[..., 0]
        loss = nll.mean()
        grads = torch.autograd.grad(loss + x.sum(), list(pr.values()))
        return x.detach(), loss.detach(), dict(zip(pr, grads))

    def rank(comm):
        prog = dr.RankProgram(cfg, mesh, bx, dr.KernelFns(), comm=comm)
        sp = {k: psp[k] for k in names}
        lp = {k: shard(v, sp[k], comm).requires_grad_(True)
              for k, v in p.items()}
        sub = {k: shard(v, P(bx), comm) for k, v in batch.items()}
        x = prog.embed(lp, sp, sub)
        loss = prog.logits_loss(lp, sp, shard(xf, P(bx), comm),
                                sub["labels"])
        grads = torch.autograd.grad(loss + x.sum(), list(lp.values()))
        return x.detach(), loss.detach(), dict(zip(lp, grads)), sp, comm
    out = run_ranks(sizes, rank)
    for coords, (x, loss, grads, sp, comm) in out.items():
        d = comm.index(("data",))
        rows = slice(d * b // 2, (d + 1) * b // 2)
        xr, lr, gr = ref_rows(rows)
        _close(x, xr, f"{coords} embed")
        _close(loss, lr, f"{coords} loss")
        for k in grads:
            want = gr[k]
            if cfg.fsdp and "data" in dr._axes_of(sp[k]):
                # the reduce-scatter summed both data ranks' parts
                want = ref_rows(slice(0, b // 2))[2][k] + ref_rows(
                    slice(b // 2, b))[2][k]
            _close(grads[k], shard(want, sp[k], comm), f"{coords} d{k}")


# ---------------------------------------------------------------------------
# The reckoning
# ---------------------------------------------------------------------------

def test_reckoned_unit_flops_equal_a_hand_count():
    """One unit (attention split on head_dim, MLP) on data 2 x model 2:
    the matrix products at the rank's shapes (three times for forward and
    backward) and the attention kernel's 4 D a live pair forward, 10 D
    backward; the rematerialised forward once more."""
    cfg = small_config("granite-3-2b", "dims")
    shape = InputShape("t", seq_len=32, global_batch=4, kind="train")
    rec = dr.reckon_cfg(cfg, shape, _mesh({"data": 2, "model": 2}))
    b, s, d, h, kv, hd, ff, m = (2, 32, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.hd, cfg.d_ff, 2)
    mm = (2 * b * s * d * (h + 2 * kv) * hd // m      # q, k, v
          + 2 * b * s * h * hd // m * d                # wo
          + 3 * 2 * b * s * d * ff // m)               # w1, w3, w2
    attn = b * h * (s * (s + 1) // 2) * hd
    assert rec["unit_flops"] == 3 * mm + 14 * attn
    assert rec["flops_by_part"]["units_remat"] == cfg.n_units * (
        mm + 4 * attn)
    assert rec["unit_param_bytes"]["units"] == 4 * (
        d * (h + 2 * kv) * hd // m + h * hd // m * d + 3 * d * ff // m
        + 2 * d)


@pytest.mark.parametrize("arch,shape_name,mesh_name", [
    ("granite-3-2b", "train_4k", "16x16"),
    ("arctic-480b", "train_4k", "2x16x16"),
    ("seamless-m4t-medium", "decode_32k", "16x16"),
    ("recurrentgemma-9b", "prefill_32k", "2x16x16"),
    ("mamba2-1.3b", "long_500k", "16x16")])
def test_every_collective_traces_back_to_a_spec(arch, shape_name,
                                                mesh_name):
    """Reckoned in full on a fake world: each collective names specs of
    the step's trees that split over every axis it runs over, and the
    totals add up."""
    rec = dr.reckon([(arch, shape_name, mesh_name)])[0]
    cfg = get_arch(arch, shape_name)
    mesh = dr.plain_mesh(mesh_name)
    bx = steps.step_batch_axes(SHAPES[shape_name], mesh)
    trees = {"params": rules.param_specs(cfg, mesh),
             "cache": rules.cache_specs(cfg, mesh, bx=bx),
             "batch": rules.batch_specs(cfg, mesh, SHAPES[shape_name].kind)}
    assert rec["collective_records"]
    for r in rec["collective_records"]:
        named = set()
        for w in r["why"]:
            tree, path = w.split(":")
            named |= dr._axes_of(dr._leaf(trees[tree], path))
        assert set(r["axes"]) <= named, r
    for op, tot in rec["collectives"].items():
        assert tot["bytes"] == sum(r["bytes"] * r["per_step"] for r in
                                   rec["collective_records"]
                                   if r["op"] == op)
    assert rec["mesh"] == mesh_name and rec["flops"] > 0
    assert rec["bytes"]["params"] > 0


def test_reckoning_of_the_shares_names_their_launches():
    """The card shares' plans: the kernels and launches of one unit
    forward and backward, at the local shapes of the table in the
    docstring."""
    recs = dr.reckon_shares()
    want = {"granite-3-2b": {"flash_attention": 1, "flash_attention_bwd": 1},
            "seamless-m4t-medium": {"flash_attention": 3,
                                    "flash_attention_bwd": 3},
            "mamba2-1.3b": {"ssd_scan": 1, "ssd_scan_bwd": 1},
            "recurrentgemma-9b": {"rglru_scan": 2, "rglru_scan_bwd": 2,
                                  "flash_attention": 1,
                                  "flash_attention_bwd": 1}}
    for arch, launches in want.items():
        calls = dr.plan(recs[arch])
        assert dr.plan_launches(calls) == launches
        assert set(dr.check_plan(calls)) == {"sm90"}
    q = lambda arch: [c["args"][0]["shape"] for c in dr.plan(recs[arch])
                      if c["kernel"] == "flash_attention"]
    assert q("granite-3-2b") == [(16, 32, 4096, 64)]
    assert q("seamless-m4t-medium") == [(16, 1, 4096, 64), (16, 1, 4096, 64),
                                        (16, 1, 1024, 64)]
    assert q("recurrentgemma-9b") == [(16, 16, 4096, 256)]
    rg = [c for c in dr.plan(recs["recurrentgemma-9b"])
          if c["kernel"] == "rglru_scan"]
    assert rg[0]["args"][1]["shape"] == (16, 4096, 256)


# ---------------------------------------------------------------------------
# The kernels' shape rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("shape_name", sorted(SHAPES))
def test_every_share_meets_the_kernels_shape_rules(shape_name, mesh_name):
    """Every kernel call of every arch's share (one unit forward, and
    backward for train) passes its wrapper's own checks on meta tensors
    and takes the Hopper route in bf16."""
    n = 0
    for arch in sorted(ARCHS):
        if not dr.applicable(arch, shape_name):
            continue
        calls = dr.unit_plan(get_arch(arch, shape_name), SHAPES[shape_name],
                             dr.plain_mesh(mesh_name))
        assert set(dr.check_plan(calls)) <= {"sm90"}, arch
        n += len(calls)
    assert (n > 0) == (SHAPES[shape_name].kind != "decode")


def test_the_shape_rule_check_refuses_a_head_dim_shard():
    """A share that ran attention at its local head dim (64 / 16 = 4, not
    gathered first) is refused here, as the card's wrapper would."""
    call = dict(kernel="flash_attention", causal=True, window=0,
                softcap=0.0, live=10,
                args=[dict(shape=(16, 32, 64, 4), stride=(8192, 4, 128, 1),
                           dtype="bfloat16"),
                      dict(shape=(16, 8, 64, 4), stride=(2048, 4, 32, 1),
                           dtype="bfloat16")] * 1 + [
                    dict(shape=(16, 8, 64, 4), stride=(2048, 4, 32, 1),
                         dtype="bfloat16")])
    with pytest.raises(ValueError, match="head dim 4"):
        dr.check_call(call)
    call = dict(call, kernel="flash_attention_bwd",
                args=[dict(a, shape=a["shape"][:3] + (32,)) for a in
                      call["args"]])
    for a in call["args"]:
        a["stride"] = tuple(st * 8 for st in a["stride"][:3]) + (1,)
    call["args"] += [call["args"][0], call["args"][0]]
    with pytest.raises(ValueError, match="Hopper design"):
        dr.check_call(call)


def test_cli_writes_and_resumes(tmp_path):
    out = tmp_path / "dr.json"
    got = dr.main(["--arch", "mamba2-1.3b", "--shape", "long_500k",
                   "--out", str(out), "--unroll", "--no-probes"])
    assert [r["mesh"] for r in got] == ["16x16", "2x16x16"]
    again = dr.main(["--arch", "mamba2-1.3b", "--shape", "long_500k",
                     "--single-pod-only", "--out", str(out), "--resume"])
    assert len(again) == 2
    skip = dr.main(["--arch", "granite-3-2b", "--shape", "long_500k",
                    "--multi-pod-only"])
    assert skip == []
    assert not mesh_lib.dist.is_initialized()


@pytest.mark.parametrize("arch", dr.SHARES)
def test_share_runs_on_the_cpu(arch):
    """A card share cut to B 1 x S 64 (fp32) runs here: the wrappers' CPU
    dispatch (the attention through ``FlashAttention``'s written-out
    backward) and the plain versions under autograd (the attention by
    rows, ``_PlainByRows``) agree to 1e-5 of each output's and gradient's
    largest magnitude, every value finite, and its shards hold the
    reckoned bytes of one unit."""
    run, params, _ = dr.build_share(arch, "cpu", batch=1, seq=64,
                                    dtype="float32")
    got = dr.compare_share(run)
    assert got["finite"], got
    assert got["out_rel_err"] <= 1e-5 and got["grad_rel_err"] <= 1e-5, got
    want = dr.unit_share_bytes(dr.share_config(arch, "float32"),
                               dr.plain_mesh(dr.SHARE_MESH))
    for stack, p in params.items():
        assert sum(t.numel() * t.element_size()
                   for t in tree_leaves(p)) == want[stack]


def _sd_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_sd_bytes(v) for v in tree.values())
    shape, dt = tree
    return math.prod(shape) * torch.empty((), dtype=dt).element_size()


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_unit_share_bytes_equal_the_shards_a_share_draws(arch, mesh_name):
    """The reckoning's shard bytes of one unit of each stack (the model's
    own unit under the whole model's specs) equal those of the shards
    ``RankProgram.unit_shapes`` draws (the blocks' specs of
    ``steps.unit_params_specs``), stack by stack."""
    cfg = get_arch(arch, "train_4k")
    mesh = dr.plain_mesh(mesh_name)
    prog = dr.RankProgram(cfg, mesh, ("data",), dr.KernelFns())
    stacks = {"units": cfg.pattern, "remainder": cfg.remainder,
              "enc_units": cfg.enc_pattern if cfg.is_encdec else ()}
    want = {st: _sd_bytes(prog.unit_shapes(sp))
            for st, sp in stacks.items() if sp}
    assert dr.unit_share_bytes(cfg, mesh) == want


def test_unit_share_bytes_see_a_share_drawn_wrong(monkeypatch):
    """A share whose shards were drawn at other shapes than the model's
    (here its unit tree reckoned with twice the d_ff) no longer holds the
    reckoned bytes: the card's check can fail."""
    cfg = get_arch("granite-3-2b", "train_4k")
    mesh = dr.plain_mesh("16x16")
    real = steps.unit_params_specs
    monkeypatch.setattr(dr.steps_lib, "unit_params_specs", lambda c, sp: real(
        dataclasses.replace(c, d_ff=2 * c.d_ff), sp))
    prog = dr.RankProgram(cfg, mesh, ("data",), dr.KernelFns())
    assert _sd_bytes(prog.unit_shapes(cfg.pattern)) != \
        dr.unit_share_bytes(cfg, mesh)["units"]
