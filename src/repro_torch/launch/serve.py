"""Serving driver: routed inference over a pool of candidate models
(counterpart of ``repro/launch/serve.py``).

Queries stream in, the ``RouterService`` picks two candidates per query,
both can generate (``--with-generation``: greedy decode on reduced
candidate LMs), preference feedback is drawn from the pool's latent skill
profile, and the posterior adapts online.

    PYTHONPATH=src python -m repro_torch.launch.serve --rounds 40 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve --autopilot \\
        --budget 0.5 --pool-schedule "+arctic-480b@5"
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --rounds 3 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arrival poisson:2000 --buckets 4,8 --rounds 2 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve --refresh-every 16

``--arrival`` serves an event-time arrival stream instead of synchronous
rounds: requests are cut into dynamic batches (``--max-wait``), padded
onto the ``--buckets`` ladder and routed through ``route_stream`` (one
CUDA graph per bucket on the card); it reports routed queries per second
and p50 / p99 latency (event-time wait plus measured route time).
``--refresh-every`` runs the online representation refresh loop. It runs
on the CUDA card unless ``--device cpu`` is given.

``--mesh DATA,MODEL`` serves through the mesh service
(``RouterService(mesh=...)``) on a (data, model) mesh of DATA x MODEL
ranks, each running this same program over the global batch. With
``--device cpu`` and no launcher it starts its own gloo world of that many
processes (rank 0 prints); under ``torchrun`` it joins the world torchrun
started; on the card a world of one, ``--mesh 1,1``, runs on NCCL:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mesh 2,2 --rounds 3 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve --mesh 1,1
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.core import baselines, fgts
from repro_torch.core import model_pool as mp
from repro_torch.core.btl import sample_preference
from repro_torch.core.draws import KeyedDraws
from repro_torch.core.policy import cost_tilt_vector, fgts_policy
from repro_torch.data.pool import synthetic_pool
from repro_torch.data.synth import CorpusConfig, make_split, sample_queries
from repro_torch.device import resolve_device
from repro_torch.encoder import EncoderConfig, init_encoder
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import lm
from repro_torch.serving import stream
from repro_torch.serving.router_service import (RouterService,
                                                RouterServiceConfig)

# Any RoutingPolicy can serve. ``arms`` is the (K, d) embedding table of a
# static service or the ModelPool of a dynamic one (k_max set); every
# constructor takes either.
POLICIES = {
    # cfg.use_kernel arrives resolved from the service (False only when
    # the caller asks for the plain selection)
    "fgts": lambda arms, costs, cfg: fgts_policy(
        arms, cfg.fgts, costs=costs, cost_tilt=cfg.cost_tilt,
        use_kernel=cfg.use_kernel),
    # dynamic pools get cost_tilt= (live pool costs, hot adds included)
    # instead of a construction-time tilt vector
    "eps_greedy": lambda arms, costs, cfg: baselines.eps_greedy_policy(
        arms, baselines.EpsGreedyConfig(n_models=cfg.fgts.n_models,
                                        dim=cfg.fgts.dim),
        tilt=None if isinstance(arms, mp.ModelPool)
        else cost_tilt_vector(costs, cfg.cost_tilt),
        cost_tilt=cfg.cost_tilt, use_kernel=cfg.use_kernel),
    "linucb": lambda arms, costs, cfg: baselines.linucb_duel_policy(
        arms, baselines.LinUCBConfig(n_models=cfg.fgts.n_models,
                                     dim=cfg.fgts.dim),
        tilt=None if isinstance(arms, mp.ModelPool)
        else cost_tilt_vector(costs, cfg.cost_tilt),
        cost_tilt=cfg.cost_tilt),
    "uniform": lambda arms, costs, cfg: baselines.uniform_policy(
        arms if isinstance(arms, mp.ModelPool) else cfg.fgts.n_models,
        device=costs.device),
}

# The candidate pool of the serving runs (each entry's latent skill
# vector drives the synthetic preferences).
DEFAULT_POOL = ["granite-3-2b", "qwen2-7b", "mamba2-1.3b",
                "recurrentgemma-9b", "gemma2-9b"]

def greedy_decode(cfg, params, prompt, n_new: int):
    """Prefill, then ``n_new - 1`` greedy decode steps; the new tokens."""
    pos = prompt.shape[1]
    logits, cache = lm.prefill(params, {"tokens": prompt}, cfg,
                               cache_len=pos + n_new)
    toks = [torch.argmax(logits[0])]
    for i in range(n_new - 1):
        logits, cache = lm.decode_step(params, cache, toks[-1][None],
                                       pos + i, cfg)
        toks.append(torch.argmax(logits[0]))
    return torch.stack(toks).tolist()


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--gen-tokens", type=int, default=8)
    ap.add_argument("--with-generation", action="store_true",
                    help="greedy-decode from the two routed models")
    ap.add_argument("--policy", choices=sorted(POLICIES), default="fgts",
                    help="RoutingPolicy serving the pool")
    ap.add_argument("--feedback-delay", type=int, default=0,
                    help="rounds between a duel being issued and its vote "
                         "arriving (0 = synchronous act->update ticks)")
    ap.add_argument("--feedback-expiry", type=int, default=None,
                    help="drop votes older than this many rounds")
    ap.add_argument("--stale-half-life", type=float, default=None,
                    help="age-discount half-life (rounds) for stale votes")
    ap.add_argument("--pool-schedule", default=None, metavar="EVENTS",
                    help="dynamic-pool membership events, comma-separated: "
                         "'+ARCH@R' hot-adds a CCFT-warm-started ARCH at "
                         "round R, '-K@R' retires slot K — e.g. "
                         "'+arctic-480b@5,-0@12'. Enables k_max = "
                         "len(pool) + #adds")
    ap.add_argument("--autopilot", action="store_true",
                    help="closed-loop pool management (dominance "
                         "retirement, A/B candidates, cost governor); "
                         "implies a dynamic pool")
    ap.add_argument("--budget", type=float, default=None, metavar="COST",
                    help="autopilot cost governor target: mean realized "
                         "duel cost ($/1k tok) held via the lambda tilt")
    ap.add_argument("--autopilot-every", type=int, default=4,
                    help="rounds between autopilot control ticks")
    ap.add_argument("--pref-dist", default=None, metavar="SPEC",
                    help="per-request preference tilts: 'grid:V1,V2,...' "
                         "cycles the listed cost weights over batch rows, "
                         "'uniform:LO,HI' samples one per request")
    ap.add_argument("--refresh-every", type=int, default=0, metavar="DUELS",
                    help="online representation refresh: once this many new "
                         "duels are in the log, re-run CCFT against the "
                         "logged outcomes (inverse-propensity-calibrated) "
                         "and hot-swap the embedding table (0 = off; "
                         "implies a dynamic pool)")
    ap.add_argument("--refresh-naive", action="store_true",
                    help="refresh ablation: score logged duels without the "
                         "IPW correction for the router's selection bias")
    ap.add_argument("--arrival", default=None, metavar="SPEC",
                    help="serve an event-time arrival stream instead of "
                         "synchronous rounds: 'poisson:RATE', "
                         "'bursty:RATE[,BURST]' or "
                         "'diurnal:RATE[,DEPTH[,PERIOD]]' (requests/sec); "
                         "total requests = --rounds * --batch")
    ap.add_argument("--buckets", default="8,16,32,64", metavar="B1,B2,...",
                    help="pow2 padding-bucket ladder for --arrival (one "
                         "program, a CUDA graph on the card, per bucket)")
    ap.add_argument("--max-wait", type=float,
                    default=stream.DEFAULT_MAX_WAIT, metavar="SECONDS",
                    help="longest a request may wait for batchmates before "
                         "its batch is cut")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="serve mesh-sharded over a (data, model) mesh of "
                         "DATA x MODEL ranks — e.g. 2,2 with --device cpu, "
                         "1,1 on one card; --batch must divide over DATA")
    return ap.parse_args(argv)


def parse_mesh(spec: str) -> tuple[int, int]:
    try:
        data, model = (int(v) for v in spec.split(","))
    except ValueError:
        raise SystemExit(
            f"--mesh expects two comma-separated sizes DATA,MODEL (e.g. "
            f"2,2), got {spec!r}") from None
    if data < 1 or model < 1:
        raise SystemExit(f"--mesh sizes must be positive, got {spec!r}")
    return data, model


def _open_mesh(args, argv, dev):
    """``--mesh``: None and the DeviceMesh, or, when this process starts
    its own gloo world, rank 0's result and None."""
    import torch.distributed as dist
    data, model = parse_mesh(args.mesh)
    if args.batch % data:
        raise SystemExit(f"--batch {args.batch} must divide over the "
                         f"mesh's data axis ({data})")
    n = data * model
    if dev.type == "cpu" and n > 1 and not dist.is_initialized() \
            and "WORLD_SIZE" not in os.environ:
        print(f"[serve] starting a gloo world of {n} processes")
        argv = list(sys.argv[1:] if argv is None else argv)
        return mesh_lib.spawn_world(main, n, (argv,), timeout=None)[0], None
    mesh_lib.init_world(dev)
    if dist.get_rank() != 0:
        sys.stdout = open(os.devnull, "w")
    if dist.get_world_size() != n:
        raise SystemExit(f"--mesh {args.mesh} needs a world of {n} ranks, "
                         f"not {dist.get_world_size()}")
    mesh = mesh_lib.make_debug_mesh(data, model, dev)
    print(f"[serve] mesh {data}x{model} ('data', 'model') over "
          f"{n} {dist.get_backend()} ranks")
    return None, mesh


def make_pref_sampler(spec):
    """(draws, round, batch, device) -> (B,) prefs, or None."""
    if not spec:
        return None
    kind, _, body = spec.partition(":")
    try:
        vals = [float(v) for v in body.split(",")] if body else []
    except ValueError:
        vals = None
    if kind == "grid" and vals:
        def grid(draws, r, b, dev):
            g = torch.tensor(vals, dtype=torch.float32, device=dev)
            return g[(r * b + torch.arange(b, device=dev)) % g.shape[0]]
        return grid
    if kind == "uniform" and vals is not None and len(vals) == 2:
        lo, hi = vals

        def uniform(draws, r, b, dev):
            return lo + (hi - lo) * draws.uniform((b,), dev)
        return uniform
    raise SystemExit(f"--pref-dist {spec!r} must be 'grid:V1,V2,...' or "
                     f"'uniform:LO,HI'")


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    pref_sampler = make_pref_sampler(args.pref_dist)
    mesh = None
    if args.mesh:
        done, mesh = _open_mesh(args, argv, dev)
        if mesh is None:
            return done

    buckets = spec = None
    if args.arrival:
        for flag, bad in (("--pool-schedule", args.pool_schedule),
                          ("--autopilot", args.autopilot),
                          ("--with-generation", args.with_generation),
                          ("--feedback-delay", args.feedback_delay)):
            if bad:
                raise SystemExit(
                    f"--arrival streams the core routing loop; {flag} is a "
                    f"synchronous-rounds feature")
        try:
            spec = stream.parse_arrival(args.arrival)
            buckets = stream.validate_buckets(
                int(v) for v in args.buckets.split(","))
        except ValueError as e:
            raise SystemExit(f"[serve] {e}") from None

    events = []
    if args.pool_schedule:
        for tok in args.pool_schedule.split(","):
            body, _, rnd = tok.strip().rpartition("@")
            if body.startswith("+"):
                events.append(("add", body[1:], int(rnd)))
            elif body.startswith("-"):
                events.append(("retire", int(body[1:]), int(rnd)))
            else:
                raise SystemExit(f"--pool-schedule event {tok!r} must be "
                                 f"'+ARCH@ROUND' or '-SLOT@ROUND'")

    ks = KeyedDraws(args.seed).split(8)
    gen = torch.Generator().manual_seed(args.seed)   # weights and queries
    n_cats, emb_dim = 5, 64
    pool_names = DEFAULT_POOL
    # arrivals share the latent category space: build the whole zoo at
    # once, serve the prefix
    arrival_names = [a for kind, a, _ in events if kind == "add"]
    all_entries, skills, protos = synthetic_pool(
        ks[0], pool_names + arrival_names, n_cats, emb_dim, device=dev)
    pool = all_entries[:len(pool_names)]
    arrivals = dict(zip(arrival_names, all_entries[len(pool_names):]))
    k_max = len(pool_names) + len(arrival_names) \
        if (events or args.autopilot or args.refresh_every) else None
    ap_cfg = None
    if args.autopilot:
        from repro_torch.autopilot import AutopilotConfig
        ap_cfg = AutopilotConfig(every=args.autopilot_every,
                                 budget=args.budget)
    rcfg = None
    if args.refresh_every:
        from repro_torch.refresh import RefreshConfig
        rcfg = RefreshConfig(every=args.refresh_every, n_categories=n_cats,
                             causal=not args.refresh_naive, epochs=1,
                             steps_per_epoch=10, batch=32)
    enc_cfg = EncoderConfig(d_model=emb_dim, n_layers=2, n_heads=4, d_ff=256,
                            max_len=32)
    enc_params = init_encoder(gen, enc_cfg, device=dev)

    n_models = k_max if k_max is not None else len(pool)
    fcfg = fgts.FGTSConfig(n_models=n_models, dim=emb_dim,
                           horizon=args.rounds * args.batch, eta=2.0, mu=0.2,
                           sgld_steps=10, sgld_eps=2e-4, sgld_minibatch=32)
    svc = RouterService(
        pool, enc_params, enc_cfg,
        RouterServiceConfig(fgts=fcfg, cost_tilt=0.0,
                            policy_factory=POLICIES[args.policy],
                            feedback_expiry=args.feedback_expiry,
                            stale_half_life=args.stale_half_life,
                            k_max=k_max, autopilot=ap_cfg, refresh=rcfg,
                            buckets=buckets, seed=args.seed),
        device=dev, mesh=mesh)

    gen_models = {}
    if args.with_generation:
        for name in pool_names:
            cfg = ARCHS[name].reduced()
            gen_models[name] = (cfg, lm.init_params(gen, cfg, device=dev))

    cc = CorpusConfig(n_categories=n_cats, seq_len=32)
    refresh_tick = None
    if args.refresh_every:
        from repro_torch.refresh import refresh_table
        # the offline corpus CCFT was fine-tuned on: the refresh re-runs it
        # with anchors tilted to the live category mix
        offline = make_split(torch.Generator().manual_seed(args.seed + 6),
                             16, cc, dev)

        def refresh_tick(step):
            if not svc.refresh_due():
                return
            table, info = refresh_table(
                ks[7].fold_in(step), svc.export_log(), enc_params, enc_cfg,
                offline, rcfg, n_models, costs=svc.costs)
            svc.apply_table(table)
            mix = np.round(info["mix"].cpu().numpy(), 2)
            print(f"[serve] step {step}: representation refresh on "
                  f"{info['n_duels']} logged duels (mix={mix}, "
                  f"{'IPW' if rcfg.causal else 'naive'} scores) — table "
                  f"hot-swapped")
    if args.arrival:
        row_of_slot = np.arange(n_models) % skills.shape[0]
        return _serve_stream(args, spec, buckets, svc, skills, row_of_slot,
                             cc, n_cats, ks, gen, pref_sampler, refresh_tick)
    regrets, pref_log, duel_cost_log = [], [], []
    in_flight = []            # (due_round, tickets, y): votes on their way
    # slot -> latent-skills row (arrivals may land in any freed slot)
    row_of_slot = np.arange(n_models) % skills.shape[0]
    arrival_row = {n: len(pool_names) + i
                   for i, n in enumerate(arrival_names)}
    all_names = pool_names + arrival_names
    t0 = time.time()
    for r in range(args.rounds):
        for kind, what, rnd in events:
            if rnd != r:
                continue
            if kind == "add":
                slot = svc.add_model(arrivals[what])
                row_of_slot[slot] = arrival_row[what]
                # offline -> online warm start: BTL duels of the new arm
                # against active incumbents on a small offline split
                cats_off = torch.randint(0, n_cats, (16,), generator=gen)
                toks_off, mask_off = sample_queries(gen, cats_off, cc, dev)
                x_off = svc.embed(toks_off, mask_off)
                utils_off = skills[torch.from_numpy(row_of_slot).to(dev)][
                    :, cats_off.to(dev)].T
                n_seed = svc.seed_replay(*mp.warm_start_duels(
                    ks[4].fold_in(r), x_off, utils_off, slot,
                    svc.active_mask(), feedback_scale=8.0))
                print(f"[serve] round {r}: +{what} -> slot {slot} "
                      f"(CCFT warm start, {n_seed} seeded duels)")
            else:
                svc.retire_model(what)
                print(f"[serve] round {r}: retired slot {what}")
        cats = torch.randint(0, n_cats, (args.batch,), generator=gen)
        toks, mask = sample_queries(gen, cats, cc, dev)
        cats = cats.to(dev)
        x = svc.embed(toks, mask)
        prefs = None if pref_sampler is None else pref_sampler(
            ks[5].fold_in(r), r, args.batch, dev)
        a1, a2, tickets = svc.route_batch(
            x, prefs=prefs, cats=cats if args.refresh_every else None)
        if prefs is not None:
            pref_log.append(prefs.cpu().numpy())
            duel_cost_log.append((0.5 * (svc.costs[a1.long()]
                                         + svc.costs[a2.long()])).cpu()
                                 .numpy())
        if args.with_generation:
            for b in range(min(args.batch, 2)):   # a couple per round
                for arm in a1[b].item(), a2[b].item():
                    arch = all_names[int(row_of_slot[arm])]
                    if arch not in gen_models:
                        continue      # scheduled arrivals have no LM here
                    cfg, params = gen_models[arch]
                    out = greedy_decode(cfg, params,
                                        toks[b:b + 1, :8] % cfg.vocab_size,
                                        args.gen_tokens)
                    if r == 0 and b == 0:
                        print(f"[serve]   {arch:<18} generated {out}")
        rows = torch.arange(args.batch, device=dev)
        utils = skills[torch.from_numpy(row_of_slot).to(dev)][:, cats].T
        y = sample_preference(ks[3].fold_in(r),
                              8.0 * utils[rows, a1.long()],
                              8.0 * utils[rows, a2.long()])
        if args.feedback_delay == 0:
            svc.feedback_batch(tickets, y)
        else:
            in_flight.append((r + args.feedback_delay, tickets, y))
        # votes issued --feedback-delay rounds ago land at the end of this
        # round, so a D-round lag resolves at service age exactly D
        due = [f for f in in_flight if f[0] <= r]
        in_flight = [f for f in in_flight if f[0] > r]
        for _, due_tickets, due_y in due:
            svc.feedback_batch(due_tickets, due_y)
        svc.expire_pending()
        if refresh_tick is not None:
            refresh_tick(r)
        # regret against the best *active* arm
        if svc.dynamic:
            act = torch.from_numpy(svc.active_mask()).to(dev)
            best = torch.where(act[None, :], utils, -torch.inf).amax(-1)
        else:
            best = utils.amax(-1)
        reg = torch.mean(best - 0.5 * (utils[rows, a1.long()]
                                       + utils[rows, a2.long()]))
        regrets.append(reg.item())
        ap_note = ""
        if args.autopilot:
            st = svc.autopilot_status()
            ap_note = (f" lam={st['lambda']:.3f} "
                       f"cost_ema={st['cost_ema']:.3f} "
                       f"active={int(st['active'].sum())}"
                       f"/{len(st['active'])} "
                       f"cand={int(st['candidate'].sum())}")
        print(f"[serve] round {r}: batch-regret={regrets[-1]:.4f} "
              f"cost=${svc.spend(a1).item():.3f} "
              f"pending={svc.pending_count()}{ap_note} "
              f"({time.time() - t0:.1f}s)")
    early = np.mean(regrets[:max(args.rounds // 4, 1)])
    late = np.mean(regrets[-max(args.rounds // 4, 1):])
    stats = svc.service_stats()
    print(f"[serve] regret early={early:.4f} late={late:.4f} "
          f"(adaptive: {'yes' if late < early else 'no'}) "
          f"routed={stats['n_routed']} folded={stats['n_folded']} "
          f"duel-cost=${stats['duel_cost']:.2f} "
          f"unresolved={stats['pending']}")
    if pref_log:
        # realized duel cost by the pref each request carried
        pv, cv = np.concatenate(pref_log), np.concatenate(duel_cost_log)
        edges = np.unique(np.round(pv, 6))
        if edges.size > 8:                     # continuous: quartiles
            edges = np.quantile(pv, [0.0, 0.25, 0.5, 0.75])
        parts = []
        for i, lo in enumerate(edges):
            hi = edges[i + 1] if i + 1 < edges.size else np.inf
            sel = (pv >= lo) & (pv < hi) if edges.size > 1 else pv >= lo
            if sel.any():
                parts.append(f"pref>={lo:g}: ${cv[sel].mean():.3f}")
        print("[serve] realized duel cost by pref  " + "  ".join(parts))
    if args.autopilot:
        st = svc.autopilot_status()
        names = [p.name if p is not None else "-" for p in svc.pool]
        alive = [n for n, a in zip(names, st["active"]) if a]
        cands = [n for n, c in zip(names, st["candidate"]) if c]
        print(f"[serve] autopilot: lam={st['lambda']:.3f} "
              f"cost_ema={st['cost_ema']:.3f} active={alive} "
              f"candidates={cands}")
    return dict(regrets=regrets, stats=stats)


def _serve_stream(args, spec, buckets, svc, skills, row_of_slot, cc, n_cats,
                  ks, gen, pref_sampler, refresh_tick=None):
    """Event-time streaming serving: cut the simulated arrival stream into
    dynamic batches (``--max-wait`` deadline forming), route them through
    the bucket programs, and report routed queries per second and the
    latency tails: a request's event-time wait for its batch plus the
    measured route time (ending in a sync on the card)."""
    dev = svc.device
    n_total = args.rounds * args.batch
    times = stream.arrival_times(spec, n_total, seed=args.seed)
    batches = stream.form_batches(times, buckets, args.max_wait)
    print(f"[serve] streaming {args.arrival}: {n_total} requests -> "
          f"{len(batches)} batches on buckets {buckets} "
          f"(max_wait {args.max_wait * 1e3:g}ms)")
    lat, regrets = [], []
    report = max(len(batches) // 8, 1)
    t0 = time.time()
    for i, fb in enumerate(batches):
        cats = torch.randint(0, n_cats, (fb.n,), generator=gen)
        toks, mask = sample_queries(gen, cats, cc, dev)
        cats = cats.to(dev)
        # embed at bucket width: one encoder shape per bucket, not per n
        x = svc.embed(stream.pad_rows(toks, fb.bucket),
                      stream.pad_rows(mask, fb.bucket))[:fb.n]
        prefs = None if pref_sampler is None else pref_sampler(
            ks[5].fold_in(i), i, fb.n, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t_r = time.time()
        a1, a2, tickets = svc.route_stream(
            x, prefs=prefs, cats=cats if refresh_tick is not None else None)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        service = time.time() - t_r
        lat.append(fb.t_form - times[fb.start:fb.start + fb.n] + service)
        utils = skills[torch.from_numpy(row_of_slot).to(dev)][:, cats].T
        rows = torch.arange(fb.n, device=dev)
        y = sample_preference(ks[3].fold_in(i), 8.0 * utils[rows, a1.long()],
                              8.0 * utils[rows, a2.long()])
        svc.feedback_stream(tickets, y)
        if refresh_tick is not None:
            refresh_tick(i)
        reg = torch.mean(utils.amax(-1) - 0.5 * (utils[rows, a1.long()]
                                                 + utils[rows, a2.long()]))
        regrets.append(reg.item())
        if i % report == 0:
            print(f"[serve] batch {i}: n={fb.n} bucket={fb.bucket} "
                  f"wait_ms={(fb.t_form - times[fb.start]) * 1e3:.1f} "
                  f"regret={regrets[-1]:.4f} ({time.time() - t0:.1f}s)")
    wall = time.time() - t0
    lat = np.concatenate(lat)
    stats = svc.service_stats()
    early = np.mean(regrets[:max(len(regrets) // 4, 1)])
    late = np.mean(regrets[-max(len(regrets) // 4, 1):])
    pad_eff = n_total / sum(fb.bucket for fb in batches)
    qps = n_total / wall
    p50, p99 = (float(np.percentile(lat, q)) for q in (50, 99))
    print(f"[serve] streaming done: qps={qps:.0f} p50={p50 * 1e3:.2f}ms "
          f"p99={p99 * 1e3:.2f}ms pad={pad_eff:.2f} "
          f"regret early={early:.4f} late={late:.4f} "
          f"(adaptive: {'yes' if late < early else 'no'}) "
          f"routed={stats['n_routed']} folded={stats['n_folded']} "
          f"unresolved={stats['pending']}")
    return dict(regrets=regrets, stats=stats, qps=qps, p50_s=p50, p99_s=p99,
                batches=len(batches), padding_efficiency=pad_eff)


if __name__ == "__main__":
    main()
