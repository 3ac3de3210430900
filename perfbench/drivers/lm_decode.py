"""The LM decode cells: ``sessions`` chat sessions with ``context``-token
histories in a ``cache_len``-slot cache decode greedily, one
``models/lm.py::decode_step`` for all sessions at a time, each step's
tokens taken to the host.

Set-up prefills the sessions ``prefill_rows`` rows at a time and copies
each chunk's cache into the sessions' cache; the first token of every
session comes from that prefill. The check runs the reference over a
sample of sessions' prompts and served tokens and reads the widest gap of
a served token.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.lib import roofline
from perfbench.lib.ctx import sync, trace_step

from . import lm_common


class State:
    """Set-up's objects and the window's record."""


def _put_rows(dst, src, lo: int, hi: int) -> None:
    """Copy a chunk's cache into rows [lo, hi) of the sessions' cache
    (``slot_pos`` is shared by the rows, so it is copied whole)."""
    for k, v in src.items():
        if isinstance(v, dict):
            _put_rows(dst[k], v, lo, hi)
        elif k == "slot_pos":
            dst[k].copy_(v)
        else:
            dst[k][:, lo:hi].copy_(v)


def sessions_cache(mc, n: int, cache_len: int, device) -> dict:
    """The sessions' empty cache in the port's stacked layout, made whole
    (``lm.init_cache`` makes it unit by unit and stacks, which holds it
    twice)."""
    u, kv, hd = mc.n_units, mc.n_kv_heads, mc.hd
    dt = getattr(torch, mc.dtype)
    z = lambda: torch.zeros((u, n, cache_len, kv, hd), dtype=dt, device=device)
    return {"units": {"0": {"kv": {
        "k": z(), "v": z(),
        "slot_pos": torch.full((u, cache_len), -1, dtype=torch.int32,
                               device=device)}}}}


def setup(ctx):
    from repro_torch.models import lm
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    st = State()
    st.mc = lm_common.model_config(cfg)
    st.p = lm_common.params(cfg, ctx.seed, dev)
    n, s = tr["sessions"], tr["context"]
    gen = torch.Generator(device=dev).manual_seed(int(ctx.seed) ^ 0xDEC)
    st.prompts = torch.randint(1, cfg["vocab_size"], (n, s), generator=gen,
                               device=dev, dtype=torch.int32)
    st.cache = sessions_cache(st.mc, n, tr["cache_len"], dev)
    rng = np.random.default_rng([ctx.seed, 17])
    st.rows = torch.from_numpy(np.sort(rng.choice(
        n, size=tr["check"]["sessions"], replace=False))).to(dev)
    first = []
    r = tr["prefill_rows"]
    for lo in range(0, n, r):
        logits, c = lm.prefill(st.p, {"tokens": st.prompts[lo:lo + r]},
                               st.mc, tr["cache_len"])
        _put_rows(st.cache, c, lo, lo + r)
        first.append(logits)
        del c
    logits = torch.cat(first)
    st.tok = logits.argmax(-1).to(torch.int32)
    st.served = [st.tok.cpu()]
    st.kept = [logits[st.rows]]
    # warm-up: one step at the window's first position, then the cache's
    # slot for it is written again by the window's first step
    logits, _ = lm.decode_step(st.p, st.cache, st.tok, s, st.mc)
    logits.argmax(-1).cpu()
    sync(dev)
    return st


def window(ctx, st) -> None:
    from repro_torch.models import lm
    tr, dev = ctx.traffic, ctx.device
    pos = tr["context"]
    st.done = []
    ctx.tracer.start()
    t0 = ctx.window_started()
    t_end = t0 + ctx.seconds
    st.trace_steps = 0
    while ctx.now() < t_end:
        if pos >= tr["cache_len"]:
            raise RuntimeError("the sessions' cache filled inside the window")
        t1 = ctx.now()
        logits, _ = lm.decode_step(st.p, st.cache, st.tok, pos, st.mc)
        st.tok = logits.argmax(-1).to(torch.int32)
        st.kept.append(logits[st.rows])
        t2 = ctx.now()
        ctx.span("decode_step", t1, t2)
        st.served.append(st.tok.cpu())
        st.done.append(ctx.now())
        ctx.span("sync_tokens", t2, st.done[-1])
        pos += 1
        if trace_step(ctx, t0):
            st.trace_steps += 1
    ctx.tracer.stop()
    sync(dev)
    st.t_end = t_end
    cfg = ctx.config
    sz = lm_common.sizes(cfg)
    n = tr["sessions"]
    steps = sum(1 for t in st.done if t <= t_end)
    ctx.attempted = n * len(st.done)
    ctx.e2e["decode_tokens_per_s"] = n * steps / ctx.seconds
    peak, bw = cfg["peak_flops"], cfg["hbm_bytes_per_s"]
    ctx.work["bound_s:step"] = sum(roofline.bound_s(*roofline.lm_decode_step(
        n, tr["context"] + i, sz["d"], sz["h"], sz["kv"], sz["hd"], sz["ff"],
        sz["layers"], sz["vocab"], 2), peak, bw)
        for i in range(st.trace_steps))
    ctx.work["steps"] = st.trace_steps


def release(ctx, st) -> None:
    st.cache = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def check(ctx, st, mode: str = "fp32") -> dict:
    """``logit_err`` over the sampled sessions: the reference over each
    one's prompt and served tokens, at the positions whose logits chose
    them (the prefill's last, then every window step)."""
    served = torch.stack(st.served, dim=1)            # (sessions, steps+1)
    kept = torch.stack(st.kept, dim=1)                # (sample, steps+1, V)
    s = ctx.traffic["context"]
    err = 0.0
    for j, i in enumerate(st.rows.tolist()):
        toks = served[i].to(ctx.device)
        seq = torch.cat([st.prompts[i], toks[:-1]])[None]
        at = list(range(s - 1, s - 1 + toks.shape[0]))
        err = max(err, lm_common.logit_err(st.p, ctx.config, seq, at,
                                           kept[j], mode))
    return {"logit_err": err}
