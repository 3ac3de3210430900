"""The LM prefill cells: a closed loop over a backlog of prompts.

Traffic: prompt lengths from ``prompt_len``; each prompt joins the open
batch of its power-of-two length bucket (at least ``min_bucket``), which
ships when it holds ``slots_per_batch`` token slots (B x S), its rows
right-padded with ``pad_id``. Each batch runs ``models/lm.py::prefill``
and takes its first tokens (greedy) to the host.

The port's prefill returns the logits of a row's last slot, so a padded
row's first token is chosen after its padding; the check holds those
logits, which depend on every real token, to the reference run over the
same padded row (``lm_common.logit_err``).
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.lib import arrivals, roofline
from perfbench.lib.ctx import sync, trace_step

from . import lm_common


class State:
    """Set-up's objects and the window's record."""


def _backlog(tr: dict, seed: int) -> list:
    """(lengths, bucket) of every batch of the backlog, in shipping order.
    Every seed gets the same prompt lengths (drawn from ``base_seed``) in
    its own order."""
    pool = arrivals.shuffled(arrivals.query_lengths(
        np.random.default_rng([tr["base_seed"], 3]), tr["pool_prompts"],
        tr["prompt_len"]), seed)
    queues: dict[int, list] = {}
    out, slots = [], 0
    for n in pool.tolist():
        if slots >= tr["backlog_slots"]:
            break
        b = max(tr["min_bucket"], 1 << (n - 1).bit_length())
        q = queues.setdefault(b, [])
        q.append(n)
        if len(q) * b == tr["slots_per_batch"]:
            out.append((np.array(q), b))
            slots += tr["slots_per_batch"]
            queues[b] = []
    if slots < tr["backlog_slots"]:
        raise ValueError("pool_prompts is too small for backlog_slots")
    return out


def setup(ctx):
    from repro_torch.models import lm
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    st = State()
    st.mc = lm_common.model_config(cfg)
    st.p = lm_common.params(cfg, ctx.seed, dev)
    st.batches = _backlog(tr, ctx.seed)
    gen = torch.Generator(device=dev).manual_seed(int(ctx.seed) ^ 0x70C)
    total = sum(len(lens) * b for lens, b in st.batches)
    flat = torch.randint(1, cfg["vocab_size"], (total,), generator=gen,
                         device=dev, dtype=torch.int32)
    st.tokens, off = [], 0
    for lens, b in st.batches:
        t = flat[off:off + len(lens) * b].view(len(lens), b)
        cols = torch.arange(b, device=dev)
        live = cols[None, :] < torch.from_numpy(lens).to(dev)[:, None]
        st.tokens.append(torch.where(live, t, tr["pad_id"]))
        off += len(lens) * b
    # warm-up: one batch of every bucket
    seen = set()
    for i, (_, b) in enumerate(st.batches):
        if b not in seen:
            seen.add(b)
            logits, _ = lm.prefill(st.p, {"tokens": st.tokens[i]}, st.mc, b)
            logits.argmax(-1).cpu()
    sync(dev)
    return st


def window(ctx, st) -> None:
    from repro_torch.models import lm
    dev = ctx.device
    st.first, st.logits, st.done, st.traced = [], [], [], 0
    ctx.tracer.start()
    t0 = ctx.window_started()
    t_end = t0 + ctx.seconds
    i = 0
    while ctx.now() < t_end:
        if i == len(st.batches):
            raise RuntimeError("the backlog ran out inside the window")
        b = st.batches[i][1]
        t1 = ctx.now()
        logits, cache = lm.prefill(st.p, {"tokens": st.tokens[i]}, st.mc, b)
        first = logits.argmax(-1)
        st.logits.append(logits)
        del cache
        t2 = ctx.now()
        ctx.span("prefill", t1, t2)
        st.first.append(first.cpu())
        st.done.append(ctx.now())
        ctx.span("sync_first_token", t2, st.done[-1])
        if trace_step(ctx, t0):
            st.traced = i + 1
        i += 1
    ctx.tracer.stop()
    sync(dev)
    st.t_end = t_end
    _tally(ctx, st)


def _tally(ctx, st) -> None:
    cfg = ctx.config
    sz = lm_common.sizes(cfg)
    peak, bw = cfg["peak_flops"], cfg["hbm_bytes_per_s"]
    n_done = len(st.done)
    real = sum(int(st.batches[k][0].sum()) for k in range(n_done)
               if st.done[k] <= st.t_end)
    slots = 0
    flops = att = 0.0
    for k in range(st.traced):
        lens, b = st.batches[k]
        slots += len(lens) * b
        flops += sum(roofline.lm_prompt_flops(
            int(n), sz["d"], sz["h"], sz["kv"], sz["hd"], sz["ff"],
            sz["layers"], sz["vocab"]) for n in lens)
        att += sz["layers"] * roofline.bound_s(*roofline.attention(
            len(lens), sz["h"], sz["kv"], b, b, sz["hd"], True, 2), peak, bw)
    ctx.attempted = int(sum(len(st.batches[k][0]) for k in range(n_done)))
    ctx.e2e["prompt_tokens_per_s"] = real / ctx.seconds
    traced_real = sum(int(st.batches[k][0].sum()) for k in range(st.traced))
    ctx.work.update({"bound_s:model": flops / peak,
                     "bound_s:attention_bf16": att,
                     "padding_share": 100.0 * (slots - traced_real) / slots
                     if slots else None,
                     "batches": n_done})


def release(ctx, st) -> None:
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def check(ctx, st, mode: str = "fp32") -> dict:
    """``logit_err`` on a sample of the window's rows: the longest
    prompt's row, then rows drawn from the seed until ``check.slots``
    padded slots."""
    tr = ctx.traffic
    rows = [(k, r) for k in range(len(st.first))
            for r in range(len(st.batches[k][0]))]
    if not rows:
        return {"logit_err": float("inf")}
    longest = max(rows, key=lambda kr: st.batches[kr[0]][0][kr[1]])
    rng = np.random.default_rng([ctx.seed, 13])
    pick, slots = [longest], st.batches[longest[0]][1]
    for j in rng.permutation(len(rows)):
        if slots >= tr["check"]["slots"]:
            break
        if rows[j] != longest:
            pick.append(rows[j])
            slots += st.batches[rows[j][0]][1]
    err = 0.0
    for k, r in pick:
        tok = st.tokens[k][r:r + 1]
        err = max(err, lm_common.logit_err(st.p, ctx.config, tok,
                                           [tok.shape[1] - 1],
                                           st.logits[k][r:r + 1], mode))
    return {"logit_err": err}
