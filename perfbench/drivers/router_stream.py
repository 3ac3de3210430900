"""The router cells: ``RouterService`` on the streaming surface.

Each formed batch runs ``RouterService.embed`` on its rows (text traffic;
embedded traffic arrives as vectors) -> ``ccft.pad_queries`` ->
``route_stream`` (padded to its bucket inside),
then ``feedback_stream`` delivers the previous batch's votes, then the
host takes the pairs (a sync): the query is routed when the host holds
its pair.

Traffic (``traffic/<name>.json``): ``mode`` ``open`` (arrivals on the wall
clock from ``arrival``, deadline batching with ``max_wait_s`` over
``buckets``) or ``closed`` (batches of the top bucket back to back over a
pool of ``pool_batches`` distinct batches). Every seed gets the same
arrival gaps (drawn from ``arrival.base_seed``) in its own order. ``input``
``text`` (token ids,
lengths from ``query_len``) or ``embedded``. Votes are Bradley-Terry-Luce
on the arms' skills in each query's category (``vote_temperature``).

The check (``check``): the encoder's outputs on a sample of the window's
batches against the reference encoder; for a sample of the window's acts,
the SGLD refresh and the selected pairs against the reference run from the
program's state before the act (its chains and ring) with the service's
draws; the fold of the previous batch's votes into the ring; the chains
the service started from.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.lib import arrivals, roofline
from perfbench.lib.ctx import sync, trace_step
from perfbench.lib.weights import make_params
from perfbench.reference import dense
from perfbench.reference import fgts as ref_fgts

N_META = 14
# a returned arm within this share of the sample's largest |score| of the
# row's best is a near-tie, as the kernel tests count one
NEAR_TIE = 1e-5
STATE_KEYS = ("x", "a1", "a2", "y", "t", "pref")


def enc_sizes(e: dict) -> dict:
    return dict(d=e["d_model"], h=e["n_heads"], kv=e["n_heads"],
                hd=e["d_model"] // e["n_heads"], ff=e["d_ff"],
                layers=e["n_layers"], vocab=e["vocab_size"])


def arms(cfg: dict, seed: int, device):
    """(a_emb (K, 782), costs (K,)) from the config's skills and costs and
    category prototypes drawn from the seed."""
    skills = torch.tensor(cfg["arms"]["skills"], dtype=torch.float32)
    costs = torch.tensor(cfg["arms"]["cost_per_1k"], dtype=torch.float32)
    d = cfg["policy"]["dim"] - N_META
    gen = torch.Generator().manual_seed(int(seed) ^ 0xA11)
    xi = torch.randn(skills.shape[1], d, generator=gen)
    xi = xi / torch.linalg.vector_norm(xi, dim=-1, keepdim=True)
    a = torch.softmax(3.0 * skills, dim=-1) @ xi
    meta = torch.cat([skills, costs[:, None].expand_as(skills)], dim=-1)
    meta = (meta - meta.mean(0)) / meta.std(0, unbiased=False).clamp_min(1e-6)
    return torch.cat([a, meta], -1).to(device), costs.to(device)


def unit_rows(gen, n: int, d: int, device) -> torch.Tensor:
    """n unit vectors of width d from ``gen``, with the metadata slots."""
    x = torch.randn(n, d, generator=gen, device=device)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return torch.cat([x, torch.ones(n, N_META, device=device)], -1)


class Votes:
    """BTL votes of a batch from its categories and uniforms (host)."""

    def __init__(self, skills, temperature: float):
        self.skills, self.temp = np.asarray(skills, np.float64), temperature

    def __call__(self, a1, a2, cats, u) -> np.ndarray:
        d = self.skills[a1, cats] - self.skills[a2, cats]
        p = 1.0 / (1.0 + np.exp(-d / self.temp))
        return np.where(u < p, 1.0, -1.0).astype(np.float32)


class State:
    """Set-up's objects and the window's record."""


def setup(ctx):
    from repro_torch.core import fgts as p_fgts
    from repro_torch.data.pool import build_entries
    from repro_torch.encoder.model import EncoderConfig
    from repro_torch.serving import RouterService, RouterServiceConfig
    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    st = State()
    e, p = cfg["encoder"], cfg["policy"]
    st.enc_cfg = EncoderConfig(vocab_size=e["vocab_size"], d_model=e["d_model"],
                               n_layers=e["n_layers"], n_heads=e["n_heads"],
                               d_ff=e["d_ff"], max_len=e["max_len"],
                               name=cfg["name"] + "-encoder")
    st.text = tr["input"] == "text"
    st.buckets = tuple(tr["buckets"])
    st.a_emb, st.costs = arms(cfg, seed, dev)
    st.enc = make_params(enc_sizes(e), seed ^ 0xE5C, torch.float32, dev) \
        if st.text else None
    entries = build_entries(cfg["arms"]["names"], st.a_emb.cpu().numpy(),
                            cfg["arms"]["cost_per_1k"])
    fcfg = p_fgts.FGTSConfig(
        n_models=p["n_models"], dim=p["dim"], horizon=p["horizon"],
        eta=p["eta"], mu=p["mu"], prior_var=p["prior_var"],
        sgld_steps=p["sgld_steps"], sgld_eps=p["sgld_eps"],
        sgld_minibatch=p["sgld_minibatch"], sgld_temp=p["sgld_temp"],
        force_distinct=p["force_distinct"], n_chains=p["n_chains"])
    st.service_seed = (int(seed) * 2654435761 + 17) & (2**63 - 1)
    st.svc = RouterService(
        entries, st.enc, st.enc_cfg if st.text else None,
        RouterServiceConfig(fgts=fcfg, cost_tilt=p["cost_tilt"],
                            seed=st.service_seed,
                            feedback_capacity=cfg["feedback_capacity"],
                            buckets=st.buckets), device=dev)
    st.routes = 0
    s = st.svc.state
    st.init = (s.theta1.clone(), s.theta2.clone())
    st.votes = Votes(cfg["arms"]["skills"], tr["vote_temperature"])
    n_cat = len(cfg["arms"]["categories"])
    rng = np.random.default_rng([seed, 1])
    top = st.buckets[-1]
    gen = torch.Generator(device=dev).manual_seed(int(seed) ^ 0x7E47)
    # the ring's history: the program's own route and fold, top bucket
    for _ in range(tr["history_batches"]):
        x = unit_rows(gen, top, p["dim"] - N_META, dev)
        a1, a2, tk = route(st, x)
        y = st.votes(a1.cpu().numpy(), a2.cpu().numpy(),
                     rng.integers(0, n_cat, top), rng.random(top))
        st.svc.feedback_stream(tk, torch.from_numpy(y).to(dev))
    # the window's traffic
    if tr["mode"] == "open":
        a = tr["arrival"]
        n = int(a["rate"] * ctx.seconds * 1.3) + 2 * top
        st.times = arrivals.shuffled_arrivals(
            a["kind"], a["rate"], n, a["base_seed"], seed, a.get("burst", 16.0))
    else:
        n = tr["pool_batches"] * top
    st.cats = rng.integers(0, n_cat, n)
    st.u = rng.random(n)
    if st.text:
        L = e["max_len"]
        st.lens = arrivals.query_lengths(rng, n, tr["query_len"])
        st.tokens = torch.randint(1, e["vocab_size"], (n, L), generator=gen,
                                  device=dev, dtype=torch.int32)
        cols = torch.arange(L, device=dev)
        st.mask = (cols[None, :] < torch.from_numpy(st.lens).to(dev)[:, None])
        st.tokens = torch.where(st.mask, st.tokens, 0)
        st.mask = st.mask.to(torch.int32)
    else:
        st.xpool = unit_rows(gen, n, p["dim"] - N_META, dev)
    # warm-up: every bucket this cell's traffic uses, each surface once
    for b in (st.buckets if tr["mode"] == "open" else (top,)):
        x = embed(st, 0, b)[0] if st.text else st.xpool[:b]
        a1, a2, tk = route(st, x)
        st.svc.feedback_stream(tk, torch.ones(b, device=dev))
    sync(dev)
    return st


def embed(st, start: int, n: int):
    """The program's embedding of rows [start, start + n) (the encoder
    runs on the formed batch as it is; ``route_stream`` pads to the
    bucket); (x (n, dim), bucket)."""
    from repro_torch.core import ccft
    x = st.svc.embed(st.tokens[start:start + n], st.mask[start:start + n])
    return ccft.pad_queries(x, N_META), arrivals.bucket_for(n, st.buckets)


def route(st, x):
    st.routes += 1
    return st.svc.route_stream(x)


def _snapshot(svc) -> dict:
    s = svc.state
    return {k: getattr(s, k).clone() for k in STATE_KEYS}


def window(ctx, st) -> None:
    tr, dev = ctx.traffic, ctx.device
    open_loop = tr["mode"] == "open"
    top = st.buckets[-1]
    rng = np.random.default_rng([ctx.seed, 7])
    chk = tr["check"]
    st.act_batches = set(int(i) for i in rng.choice(
        np.arange(1, chk["act_first_batches"]), size=chk["acts"],
        replace=False))
    st.acts, st.batches, st.enc_out, st.traced = [], [], [], 0
    st.events = []
    prev = None
    ctx.tracer.start()
    t0 = ctx.window_started()
    t_end = t0 + ctx.seconds
    if open_loop:
        due = t0 + st.times
        batcher = arrivals.DeadlineBatcher(due, top, tr["max_wait_s"])
        st.done = np.full(due.shape[0], np.inf)
        st.cut = np.full(due.shape[0], np.inf)
    k = 0
    while True:
        now = ctx.now()
        if now >= t_end:
            break
        if open_loop:
            start, v = batcher.next_cut(now)
            if start is None:
                wait = min(v, t_end) - now
                if wait > 0:
                    time.sleep(wait)
                    ctx.span("wait_arrivals", now, ctx.now())
                continue
            n = v
        else:
            start, n = (k % tr["pool_batches"]) * top, top
        t_cut = ctx.now()
        if st.text:
            ev = None
            if ctx.trace_on and dev.type == "cuda":
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            x, b = embed(st, start, n)
            if ev is not None:
                ev[1].record()
                st.events.append((ev, n))
            ctx.span("embed", t_cut, ctx.now())
        else:
            x, b = st.xpool[start:start + n], top
        snap = None
        if k in st.act_batches:
            snap = dict(before=_snapshot(st.svc),
                        th=(st.svc.state.theta1.clone(),
                            st.svc.state.theta2.clone()), call=st.routes + 1)
        timed = ctx.trace_on and not open_loop
        if timed:
            sync(dev)
        t1 = ctx.now()
        a1, a2, tk = route(st, x)
        if timed:
            sync(dev)
        t2 = ctx.now()
        ctx.span("route_stream", t1, t2)
        if timed:
            ctx.work.setdefault("span:route_call", []).append(t2 - t1)
        if snap is not None:
            snap.update(th_after=(st.svc.state.theta1.clone(),
                                  st.svc.state.theta2.clone()),
                        x=x, a1=a1, a2=a2, prev=prev)
        if prev is not None:
            st.svc.feedback_stream(prev["tk"], prev["y"])
            if timed:
                sync(dev)
                ctx.work.setdefault("span:feedback_call", []).append(
                    ctx.now() - t2)
        if snap is not None:
            snap["after"] = _snapshot(st.svc)
            st.acts.append(snap)
        t3 = ctx.now()
        ctx.span("feedback_stream", t2, t3)
        a1h, a2h = a1.cpu().numpy(), a2.cpu().numpy()
        t_done = ctx.now()
        ctx.span("sync_pairs", t3, t_done)
        if open_loop:
            st.done[start:start + n] = t_done
            st.cut[start:start + n] = t_cut
        y = st.votes(a1h, a2h, st.cats[start:start + n],
                     st.u[start:start + n])
        prev = dict(x=x, a1=a1, a2=a2, tk=tk,
                    y=torch.from_numpy(y).to(dev))
        st.batches.append((start, n, b, t_done))
        if st.text:
            st.enc_out.append((start, n, x))
        ctx.span("votes", t_done, ctx.now())
        if trace_step(ctx, t0):
            st.traced = k + 1
        k += 1
    ctx.tracer.stop()
    sync(dev)
    st.t0, st.t_end = t0, t_end
    _tally(ctx, st, open_loop)


def _tally(ctx, st, open_loop: bool) -> None:
    cfg, tr = ctx.config, ctx.traffic
    if open_loop:
        in_window = (st.t0 + st.times) < st.t_end
        due = (st.t0 + st.times)[in_window]
        done = st.done[in_window]
        lat = np.where(np.isfinite(done), done, st.t_end) - due
        routed = int(np.sum(done <= st.t_end))
        ctx.attempted = int(in_window.sum())
        ctx.e2e["route_p95_ms"] = float(np.percentile(lat, 95) * 1e3)
        # the queries of the traced batches, as the other per-layer
        # metrics read the traced part: the trace's hand-over when it
        # stops holds the host for seconds inside the window
        rows = [np.arange(s, s + n) for s, n, _, _ in st.batches[:st.traced]]
        waits = np.concatenate(rows) if rows else np.zeros(0, np.int64)
        waits = st.cut[waits] - (st.t0 + st.times[waits])
        ctx.work["queue_wait_p50_ms"] = float(np.median(waits) * 1e3) \
            if waits.size else None
        ctx.work["backlog_at_end"] = int(np.sum(~np.isfinite(done)))
    else:
        routed = sum(n for _, n, _, t in st.batches if t <= st.t_end)
        ctx.attempted = sum(n for _, n, _, _ in st.batches)
    ctx.e2e["routed_qps"] = routed / ctx.seconds
    # the work of the traced part of the window (its first batches)
    e, p = cfg["encoder"], cfg["policy"]
    peak, bw = cfg["peak_flops"], cfg["hbm_bytes_per_s"]
    traced = st.batches[:st.traced]
    n_real = sum(n for _, n, _, _ in traced)
    acts = len(traced)
    sg_f, sg_b = roofline.sgld_grad_call(p["n_chains"], p["sgld_minibatch"],
                                         p["n_models"], p["dim"])
    calls = 2 * p["sgld_steps"] * acts
    sel = [roofline.select(b, p["n_models"], p["dim"])
           for _, _, b, _ in traced]
    ctx.work["bound_s:sgld_grad"] = calls * roofline.bound_s(sg_f, sg_b,
                                                             peak, bw)
    ctx.work["bound_s:act"] = ctx.work["bound_s:sgld_grad"] + sum(
        roofline.bound_s(f, nb, peak, bw) for f, nb in sel)
    flops = calls * sg_f + sum(6.0 * n * p["n_models"] * p["dim"]
                               for _, n, _, _ in traced)
    if st.text:
        sz = enc_sizes(e)
        L = e["max_len"]
        flops += n_real * roofline.encoder_query_flops(
            L, sz["d"], sz["h"], sz["hd"], sz["ff"], sz["layers"])
        att = sum(e["n_layers"] * roofline.bound_s(*roofline.attention(
            n, sz["h"], sz["h"], L, L, sz["hd"], False, 4), peak, bw)
            for _, n, _, _ in traced)
        ctx.work["bound_s:attention_fp32"] = att
        if st.events:
            ms = sum(a.elapsed_time(b) for (a, b), _ in st.events)
            ctx.work["encode_ms_per_kq"] = ms / (sum(
                n for _, n in st.events) / 1e3)
    ctx.work["bound_s:model"] = flops / peak


def release(ctx, st) -> None:
    """Free the program's state before the reference runs."""
    st.svc = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def check(ctx, st, mode: str = "fp32") -> dict:
    """The numbers compared. ``mode`` "fp32" judges the program's outputs;
    another mode ("tf32") judges the control, the reference computed in
    that precision in the program's place, by the same numbers.

    ``theta_gap``: the median over the sampled acts' chains of a chain's
    largest |program - reference| over its largest |reference| entry
    (``theta_gap_max``, the largest, is read beside it: a near-tie of the
    feel-good max that flips in one chain moves that chain alone).
    ``pair_gap``: the selection given the act's own chains: the largest
    amount by which a returned arm's tilted score (the reference's
    arithmetic, from the chains the act produced) lies below the row's
    best, over the sample's largest |score|; ``pair_mismatch``, the
    returned arms outside a near-tie (``NEAR_TIE``) of their row's best:
    an exact comparison. ``enc_gap``: as ``_enc_gap``. ``fold_mismatch`` and
    ``init_mismatch``: entries of the ring after the fold, and of the
    chains the service started from, that differ from the reference's."""
    cfg, tr = ctx.config, ctx.traffic
    p = cfg["policy"]
    m = dict(eps=cfg["encoder"]["norm_eps"],
             rope_theta=cfg["encoder"]["rope_theta"])
    out = {}
    control = mode != "fp32"
    rng = np.random.default_rng([ctx.seed, 11])
    if not control:
        th0 = ref_fgts.init_chains(ref_fgts.service_key(st.service_seed, 0),
                                   p["n_chains"], p["dim"], p["prior_var"],
                                   ctx.device)
        out["init_mismatch"] = float(int((th0[0] != st.init[0]).sum()
                                         + (th0[1] != st.init[1]).sum()))
    if st.text:
        out["enc_gap"] = _enc_gap(st, rng, tr["check"]["enc_rows"], m, mode)
    if not st.acts:
        return out
    tilt = p["cost_tilt"] * st.costs
    chain_gaps, pair_gap, pair_bad, fold_bad = [], 0.0, 0, 0
    for a in st.acts:
        key = ref_fgts.service_key(st.service_seed, a["call"])
        ring = a["before"]
        r1, r2 = ref_fgts.refresh(key, a["th"][0], a["th"][1], ring, st.a_emb,
                                  st.costs, p)
        if control:
            c1, c2 = ref_fgts.refresh(key, a["th"][0], a["th"][1], ring,
                                      st.a_emb, st.costs, p, mode)
            _, s1, s2 = ref_fgts.select(a["x"], st.a_emb, c1, c2, tilt, mode)
            got = (c1, c2, s1, s2)
        else:
            got = (a["th_after"][0], a["th_after"][1], a["a1"], a["a2"])
        for g, r in ((got[0], r1), (got[1], r2)):
            chain_gaps += ((g - r).abs().amax(-1)
                           / r.abs().amax(-1).clamp_min(1e-30)).tolist()
        s, _, _ = ref_fgts.select(a["x"], st.a_emb, got[0], got[1], tilt)
        for j in (0, 1):
            pick = torch.gather(s[j], -1, got[2 + j].long()[:, None])[:, 0]
            gap = (s[j].amax(-1) - pick) / s[j].abs().max().clamp_min(1e-30)
            pair_gap = max(pair_gap, float(gap.max()))
            pair_bad += int((gap > NEAR_TIE).sum())
        if not control:
            pv = a["prev"]
            want = ref_fgts.fold(ring, pv["x"], pv["a1"], pv["a2"], pv["y"])
            fold_bad += sum(int((want[k] != a["after"][k]).sum())
                            for k in STATE_KEYS)
    out["theta_gap"] = float(np.median(chain_gaps))
    out["theta_gap_max"] = float(np.max(chain_gaps))
    out["pair_gap"], out["pair_mismatch"] = pair_gap, float(pair_bad)
    if not control:
        out["fold_mismatch"] = float(fold_bad)
    return out


def _enc_gap(st, rng, budget: int, m: dict, mode: str) -> float:
    """Largest |program - reference| over the sampled rows, as a share of
    the reference's largest entry. The sample: the largest batch, then
    batches drawn from the seed until ``budget`` rows."""
    order = list(rng.permutation(len(st.enc_out)))
    big = max(range(len(st.enc_out)), key=lambda i: st.enc_out[i][1])
    order.remove(big)
    pick, rows = [big], st.enc_out[big][1]
    for i in order:
        if rows >= budget:
            break
        pick.append(i)
        rows += st.enc_out[i][1]
    gap, top = 0.0, 0.0
    for i in pick:
        start, n, x = st.enc_out[i]
        for lo in range(0, n, 256):
            hi = min(n, lo + 256)
            tok = st.tokens[start + lo:start + hi]
            msk = st.mask[start + lo:start + hi]
            ref = dense.encode(st.enc, tok, msk, m)
            got = x[lo:hi, :ref.shape[1]] if mode == "fp32" \
                else dense.encode(st.enc, tok, msk, m, mode)
            gap = max(gap, float((got - ref).abs().max()))
            top = max(top, float(ref.abs().max()))
    return gap / max(top, 1e-30)
