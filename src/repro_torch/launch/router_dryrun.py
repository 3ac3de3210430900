"""Router dry-run: the routing service at the production meshes' scale
(counterpart of ``repro/launch/router_dryrun.py``).

The reference lowers and compiles four steps of the mesh service onto the
16 x 16 and 2 x 16 x 16 TPU meshes. Torch has no ahead-of-time compile of
a partitioned program, so the port reckons what one rank of those meshes
does instead, on a world of 256 or 512 ranks of the ``fake`` back end
(collectives complete at once) over fake tensors
(``torch._subclasses.FakeTensorMode``: shapes only, the CPU's plain
versions of the kernels traced): per step, the rank's rows, its FLOPs
(``torch.utils.flop_counter.FlopCounterMode``: matrix products and
attention), the bytes of its operands and results, and the bytes each
collective of ``sharding/routing_rules.py`` moves, by operation. The
steps are the port's own programs at the reference's shapes (global batch
65536, K 10 arms, DIM 782):

  * ``route_step``: one rank's act on its rows (the selection, cost tilt
    and active mask), the all-gather of the pairs and the enqueue into
    its share of the ring (slot = ticket % C);
  * ``update_step``: one posterior refresh, 16 chains x 20 SGLD steps on
    minibatches of 256 from a 65536-row replay ring, replicated on every
    rank (the reference splits the replay rows over the batch axes);
  * ``resolve_step``: the whole vote batch resolved against the rank's
    share of a ring sized for one round of lag, and the all-reduce that
    assembles the resolved batch on every rank;
  * ``encode_route_step``: the text encoder (6 layers, d 768, 12 heads,
    128 tokens) on the rank's rows, then ``route_step``'s act.

``time_shares`` runs one rank's share of each step on the card and times
it (device ms by kernel, launches, peak memory): ``dueling_select`` at
B 4096 and 2048, the ``sgld_potential`` gradient at C 16 and m 256, the
fp32 ``flash_attention`` at B 4096 and 2048, S 128, D 64; each step's
kernel beside its bound (``share_bound``).

    PYTHONPATH=src python -m repro_torch.launch.router_dryrun [--card]

The fake world is made and destroyed here; it cannot share a process with
a started world (run it before ``init_world`` or after ``close_world``).
"""
from __future__ import annotations

import argparse
import json
import os

import torch
import torch.distributed as dist

from repro_torch import profiling
from repro_torch.core import ccft, fgts
from repro_torch.core.draws import KeyedDraws
from repro_torch.core.policy import cost_tilt_vector, select_pair
from repro_torch.data.pool import CATEGORIES, arch_ids
from repro_torch.device import resolve_device
from repro_torch.encoder.model import EncoderConfig, encode, init_encoder
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.layers import tree_leaves, tree_unflatten
from repro_torch.serving import feedback_queue as fq
from repro_torch.sharding import routing_rules as rr

K_MODELS = len(arch_ids())
DIM = 768 + 2 * len(CATEGORIES)      # production-size embedding + metadata
ENC_CFG = EncoderConfig(vocab_size=32_768, d_model=768, n_layers=6,
                        n_heads=12, d_ff=3072, max_len=128,
                        name="router-encoder-prod")
GLOBAL_BATCH = 65_536
HORIZON = 65_536
N_CHAINS = 16
COST_TILT = 0.05
SGLD = dict(sgld_steps=20, sgld_minibatch=256)
# one rank's rows of the global batch on each production mesh
SHARE_ROWS = {"16x16": GLOBAL_BATCH // 16, "2x16x16": GLOBAL_BATCH // 32}


def fgts_cfg(horizon: int = HORIZON) -> fgts.FGTSConfig:
    return fgts.FGTSConfig(n_models=K_MODELS, dim=DIM, horizon=horizon,
                           **SGLD)


def ring_capacity(global_batch: int, mesh, feedback_delay: int = 1) -> int:
    """The pending ring of ``feedback_delay`` rounds of in-flight duels."""
    return rr.round_capacity(
        min(global_batch * (feedback_delay + 1), 1 << 18), mesh)


class _ChainDraws:
    """The SGLD draws of ``c`` chains with the right shapes (fake tensors
    under the reckoning: no numbers)."""

    def __init__(self, c):
        self.c = c

    def sgld(self, n_chains, n_steps):
        return self

    def step(self, i, m, hi, d, device):
        return (torch.empty((self.c, m), dtype=torch.int64, device=device),
                torch.empty((self.c, d), dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# The steps: one rank's share, on any device
# ---------------------------------------------------------------------------

def route_step(x, a_emb, theta1, theta2, costs, active):
    """One rank's selection on its rows (the act's epilogue)."""
    return select_pair(x, a_emb, theta1, theta2,
                       tilt=cost_tilt_vector(costs, COST_TILT), mask=active)


def route_and_issue(x, a_emb, theta1, theta2, costs, active, ring, share,
                    group, n_shards, x_whole):
    """``route_step``, the all-gather of the pairs over the batch ranks
    and the enqueue of the whole batch into this rank's share of the
    ring, as ``RouterService.route_batch`` does."""
    a1, a2 = route_step(x, a_emb, theta1, theta2, costs, active)
    a1, a2 = rr.unpack_rows(rr.gather_rows(rr.pack_rows([a1, a2]), group,
                                           n_shards), [a1, a2])
    return fq.enqueue(ring, x_whole, a1, a2, 1, share=share)


def update_step(draws, theta, state, a_emb, cfg):
    """One posterior refresh: the chains theta (C, d), cfg.sgld_steps
    steps of the fused gradient, their mean."""
    return fgts.sgld_sample(draws, theta, state, a_emb, 1, cfg).mean(dim=0)


def resolve_step(ring, tickets, y, share, group):
    """The whole vote batch against this rank's share, then the sum over
    the batch ranks that gives every rank the resolved batch."""
    ring, res = fq.resolve(ring, tickets, y, 1, share=share)
    cols = [res.x, res.a1, res.a2, res.age, res.ok, res.pref, res.prop,
            res.cat]
    return ring, rr.unpack_rows(rr.sum_rows(rr.pack_rows(cols), group), cols)


def encode_route_step(enc_params, tokens, mask, a_emb, theta1, theta2, costs,
                      active, enc_cfg=ENC_CFG):
    x = encode(enc_params, tokens, mask, enc_cfg)
    x = ccft.pad_queries(x, 2 * len(CATEGORIES))
    return route_step(x, a_emb, theta1, theta2, costs, active)


# ---------------------------------------------------------------------------
# The reckoning on a fake world
# ---------------------------------------------------------------------------

def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(v) for v in tree)
    return 0


def _record(name, mesh_name, rows, fn, args):
    from torch.utils.flop_counter import FlopCounterMode
    with rr.tally() as coll, FlopCounterMode(display=False) as fc:
        out = fn(*args)
    return {"step": name, "mesh": mesh_name, "rows": rows,
            "flops": int(fc.get_total_flops()),
            "argument_bytes": _nbytes(args), "output_bytes": _nbytes(out),
            "collectives": coll,
            "collective_bytes": sum(v["bytes"] for v in coll.values())}


def _enc_cpu(enc_cfg=ENC_CFG):
    return init_encoder(torch.Generator().manual_seed(0), enc_cfg,
                        device="cpu")


def reckon_mesh(multi_pod: bool, global_batch: int = GLOBAL_BATCH,
                horizon: int = HORIZON, feedback_delay: int = 1,
                enc_params=None, enc_cfg=ENC_CFG) -> list:
    """Every step's reckoning on one rank of a production mesh, on a fake
    world of 256 (16 x 16) or 512 (2 x 16 x 16) ranks started here and
    destroyed at the end (``enc_cfg``: the encoder of
    ``encode_route_step``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    enc_params = _enc_cpu(enc_cfg) if enc_params is None else enc_params
    try:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device="cpu")
        group = rr.batch_group(mesh)
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            return _reckon_steps(mode, mesh, group, global_batch, horizon,
                                 feedback_delay, enc_params, enc_cfg)
    finally:
        dist.destroy_process_group()


def _reckon_steps(mode, mesh, group, global_batch, horizon, feedback_delay,
                  enc_params, enc_cfg) -> list:
    name = "x".join(str(s) for s in mesh.mesh.shape)
    n = rr.n_batch_shards(mesh)

    def t(spec, shape, dt=torch.float32):
        return torch.empty(rr.local_shape(spec, shape, mesh), dtype=dt,
                           device="cpu")
    f32, i32 = torch.float32, torch.int32
    # route_step: (x, a_emb, theta1, theta2, costs, active)
    x, a_emb, th, _, costs, active = (
        t(spec, shape, dt) for spec, (shape, dt) in zip(
            rr.route_step_specs(mesh),
            (((global_batch, DIM), f32), ((K_MODELS, DIM), f32),
             ((DIM,), f32), ((DIM,), f32), ((K_MODELS,), f32),
             ((K_MODELS,), torch.bool))))
    rows = x.shape[0]
    # resolve_step: the ring's fields, then (tickets, y, now)
    cap = ring_capacity(global_batch, mesh, feedback_delay)
    share = (0, cap)
    *fields, tickets, y, _ = (
        t(spec, shape, dt) for spec, (shape, dt) in zip(
            rr.resolve_step_specs(mesh),
            (((cap, DIM), f32), ((cap,), i32), ((cap,), i32),
             ((cap,), i32), ((cap,), i32), ((cap,), torch.bool), ((), i32),
             ((cap,), f32), ((cap,), f32), ((cap,), i32),
             ((global_batch,), i32), ((global_batch,), f32), ((), i32))))
    ring = fq.PendingDuels(*fields)
    x_whole = torch.empty((global_batch, DIM), device="cpu")
    out = [_record("route_step", name, rows, route_and_issue,
                   (x, a_emb, th, th, costs, active, ring, share, group,
                    n, x_whole))]
    # update_step: (theta, replay x / a1 / a2 / y, t, a_emb)
    theta, rx, ra1, ra2, ry, rt, _ = (
        t(spec, shape, dt) for spec, (shape, dt) in zip(
            rr.update_step_specs(mesh),
            (((N_CHAINS, DIM), f32), ((horizon, DIM), f32),
             ((horizon,), i32), ((horizon,), i32), ((horizon,), f32),
             ((), i32), ((K_MODELS, DIM), f32))))
    state = fgts.FGTSState(x=rx, a1=ra1, a2=ra2, y=ry, t=rt, theta1=th,
                           theta2=th, pref=torch.empty((horizon,)))
    out.append(_record("update_step", name, rows, update_step,
                       (_ChainDraws(N_CHAINS), theta, state, a_emb,
                        fgts_cfg(horizon))))
    if feedback_delay > 0:
        out.append(_record("resolve_step", name, rows, resolve_step,
                           (ring, tickets, y, share, group)))
    enc = tree_unflatten(enc_params, [mode.from_tensor(v)
                                      for v in tree_leaves(enc_params)])
    toks = t(rr.query_batch_spec(mesh), (global_batch, enc_cfg.max_len),
             torch.int32)
    msk = t(rr.query_batch_spec(mesh), (global_batch, enc_cfg.max_len))
    a_enc = torch.empty((K_MODELS, enc_cfg.d_model + 2 * len(CATEGORIES)),
                        device="cpu")
    th_enc = torch.empty((a_enc.shape[1],), device="cpu")
    out.append(_record("encode_route_step", name, rows,
                       encode_route_step,
                       (enc, toks, msk, a_enc, th_enc, th_enc, costs, active,
                        enc_cfg)))
    return out


def reckon(global_batch: int = GLOBAL_BATCH, horizon: int = HORIZON,
           feedback_delay: int = 1, enc_cfg=ENC_CFG) -> list:
    """Both production meshes' reckoning (16 x 16, then 2 x 16 x 16)."""
    if dist.is_initialized():
        raise RuntimeError("the dry-run makes its own fake world: run it "
                           "before init_world or after close_world")
    enc = _enc_cpu(enc_cfg)
    out = []
    for multi_pod in (False, True):
        out += reckon_mesh(multi_pod, global_batch, horizon, feedback_delay,
                           enc_params=enc, enc_cfg=enc_cfg)
    return out


# ---------------------------------------------------------------------------
# One rank's share on the card
# ---------------------------------------------------------------------------

# each step's kernel: (wrapper, substring of its kernels' names)
SHARE_KERNELS = {"route_step": ("dueling_select", "select_"),
                 "update_step": ("sgld_potential_grad", "fgts_kernel"),
                 "resolve_step": (None, None),
                 "encode_route_step": ("flash_attention",
                                       "flash_attention_kernel")}


def share_bound(step: str, rows: int, enc_cfg=ENC_CFG):
    """(bound ms, "bytes" or "operations") of the kernel launches of one
    rank's ``step`` at ``rows`` rows on the card: each input read once and
    each output written once over ``HBM_BW``, the operations over the
    fp32 peak (the counts ``chip_smoke.py``'s kernel cases use); None for
    a step without a kernel."""
    d, k = DIM, K_MODELS
    if step == "route_step":
        nbytes = 4 * (rows * d + k * d + 2 * d + 2 * rows) + 5 * k
        flops = 6.0 * rows * k * d
    elif step == "update_step":
        c, m, n = N_CHAINS, SGLD["sgld_minibatch"], SGLD["sgld_steps"]
        rows_bytes = c * m * (4 * d + 4 * 4 + 8 + 4)
        nbytes = n * (rows_bytes + 4 * k * d + 5 * k + 4 * c + 8 * c * d)
        flops = n * (4.0 * c * m * k * d + 7.0 * c * m * d)
    elif step == "encode_route_step":
        s, h = enc_cfg.max_len, enc_cfg.n_heads
        hd = enc_cfg.d_model // h
        nbytes = enc_cfg.n_layers * 4 * (4 * rows * s * h * hd)
        flops = enc_cfg.n_layers * 4.0 * rows * h * s * s * hd
    else:
        return None, None
    tb, tf = nbytes / mesh_lib.HBM_BW, flops / mesh_lib.PEAK_FLOPS_FP32
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def time_shares(device=None, seed: int = 0) -> list:
    """One rank's share of each step at the production meshes' row counts
    (``SHARE_ROWS``), timed on the card. Collectives are not run (the
    reckoning counts their bytes), so no world is needed."""
    from repro_torch import kernels
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("time_shares times the card: pass a CUDA device")
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(dev)
    a_emb, costs = rnd(K_MODELS, DIM), torch.rand(K_MODELS, generator=gen)
    costs = costs.to(dev)
    active = torch.ones((K_MODELS,), dtype=torch.bool, device=dev)
    th1, th2 = rnd(DIM), rnd(DIM)
    cfg = fgts_cfg()
    state = fgts.FGTSState(
        x=rnd(HORIZON, DIM),
        a1=torch.randint(0, K_MODELS, (HORIZON,), generator=gen,
                         dtype=torch.int32).to(dev),
        a2=torch.randint(0, K_MODELS, (HORIZON,), generator=gen,
                         dtype=torch.int32).to(dev),
        y=torch.where(torch.rand(HORIZON, generator=gen) < 0.5, 1.0,
                      -1.0).to(dev),
        t=torch.full((), HORIZON, dtype=torch.int32, device=dev),
        theta1=th1, theta2=th2, pref=torch.zeros((HORIZON,), device=dev))
    theta = rnd(N_CHAINS, DIM)
    enc = init_encoder(gen, ENC_CFG, device=dev)
    cap = 2 * GLOBAL_BATCH            # one round of lag, as the reckoning
    out = []
    for mesh_name, rows in SHARE_ROWS.items():
        x = rnd(rows, DIM)
        toks = torch.randint(0, ENC_CFG.vocab_size, (rows, ENC_CFG.max_len),
                             generator=gen).to(dev)
        msk = torch.ones((rows, ENC_CFG.max_len), device=dev)
        # the first rank's share: slots [0, C / S)
        ring = fq.init_pending(cap // (GLOBAL_BATCH // rows), DIM,
                               device=dev)
        tickets = torch.randint(0, cap, (GLOBAL_BATCH,), generator=gen,
                                dtype=torch.int32).to(dev)
        y = torch.ones((GLOBAL_BATCH,), device=dev)
        share = (0, cap)
        draws = KeyedDraws(seed)
        steps = {
            "route_step": lambda: route_step(x, a_emb, th1, th2, costs,
                                             active),
            "update_step": lambda: update_step(draws, theta, state, a_emb,
                                               cfg),
            "resolve_step": lambda: fq.resolve(ring, tickets, y, 1,
                                               share=share),
            "encode_route_step": lambda: encode_route_step(
                enc, toks, msk, a_emb, th1, th2, costs, active),
        }
        for name, fn in steps.items():
            kernels.reset_launch_counts()
            fn()
            torch.cuda.synchronize()
            launches = {k: v for k, v in kernels.launch_counts().items()
                        if v}
            wrapper, sub = SHARE_KERNELS[name]
            rec = dict(step=name, mesh=mesh_name, rows=rows,
                       launches=launches,
                       **profiling.timed(fn))
            rec["kernel"] = wrapper
            rec["bound_ms"], rec["bound_by"] = share_bound(name, rows)
            if wrapper is not None:
                rec["kernel_launches"] = launches.get(wrapper, 0)
                rec["kernel_device_ms"] = sum(
                    ms for key, ms in rec["device_ms_by_kernel"].items()
                    if sub in key)
            out.append(rec)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=GLOBAL_BATCH)
    ap.add_argument("--feedback-delay", type=int, default=1)
    ap.add_argument("--card", action="store_true",
                    help="also time one rank's share of each step on the "
                         "card")
    ap.add_argument("--out", default=None, help="write the records (JSON)")
    args = ap.parse_args(argv)
    rec = {"reckoning": reckon(args.batch,
                               feedback_delay=args.feedback_delay)}
    for r in rec["reckoning"]:
        print(f"[router-dryrun] {r['step']} x {r['mesh']}: rows={r['rows']} "
              f"flops/rank={r['flops']:.3e} "
              f"bytes/rank={r['argument_bytes'] + r['output_bytes']:.3e} "
              f"coll/rank={r['collective_bytes']:.3e}")
    if args.card:
        rec["card"] = time_shares()
        for r in rec["card"]:
            print(f"[router-dryrun] card {r['step']} rows={r['rows']}: "
                  f"{r['ms']:.3f} ms ({r['device_ms']:.3f} device ms) "
                  f"launches={r['launches']}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    main()
