#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--out FILE]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, in parallel) and runs three phases, printing one JSON
line per phase (phase 2 prints one per path):

1. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (K = 16 pool slots with 11 live RouterBench
   arms, d = 768, B = 256; SGLD m = 64 rows, C = 8 chains; the autopilot's
   posterior scores of 16 chains; the encoder's attention, B 256, 4 heads
   of 64, S = T = 64) and at the top row of the SGLD bench (K = 1024,
   m = 1024, C = 8; scores and selection B = 4096), plus edge cases (the
   SGLD potential also at K 1, K 33 and K 300 with duplicated arms tying
   across its 256-arm tiles, m no multiple of its rows per block; the
   scores at B 170 and 171 (K 1024, J 1), the two sides of
   ``score_plan``'s bound, and at d 100 and 98; the mixed SGLD kernels
   at m 1, 3 and 45, C 1 and d 98; every SGLD, mixed and score case must
   repeat bitwise on repeated calls). Pairs must agree outside
   near-ties (top-two gap below 1e-5 * max|s|, counted but not
   failures); scores to 1e-5 of max|s|, with duplicated arms
   bitwise equal and dominance matrices equal outside near-tied arm pairs;
   potentials to rtol 1e-5 and gradients to rtol 1e-4 of the largest
   magnitude. The attn family holds ``flash_attention`` to rtol = atol =
   2e-5 (fp32, the SIMT kernel) and 2e-2 (bf16, the Hopper kernel) on the
   reference's five test shapes in both types, rows with no live key in
   both types (they must be the mean of v), bf16 ``transpose(1, 2)`` views
   of (B,S,H,D) tensors (with a window and soft cap at D 256), ragged S/T
   at D 256, D 32 with GQA, fp32 across the SIMT kernel's double-buffered
   kv tiles (ragged S/T at D 64, 128 and 256) and through its 4-byte copies
   (unaligned views), the encoder's heads, qwen2-7b's (H 28, KV 4,
   D 128, causal, S = T = 2048, fp32 and bf16) and gemma2-9b's (H 16,
   KV 8, D 256, soft cap 50, window 4096, S = T = 8192, bf16) and
   recurrentgemma-9b's at the lm path's prefill (B 2, H 16, KV 1, D 256,
   window 2048, S = T = 4096, bf16). The
   ssd family holds ``ssd_scan`` to rtol = atol = 2e-4 and the rglru
   family ``rglru_scan`` to 1e-5 (the reference's tolerances) on the
   reference's test shapes, ragged S,
   S < chunk, S = 1, h0, bf16 x/B/C and strided column slices (rglru:
   D 96, S 1 with h0, B 1 with S no multiple of the ring's 32-step tile,
   and D 98, which takes the first kernel; bf16 at
   P 64, N 128, chunk 128 on the Hopper kernels, other bf16 shapes and
   fp32 on the SIMT kernel; misaligned bf16 slices must raise), at the LM
   path's shapes (mamba2-1.3b: B 2, S 4096, H 64, P 64, N 128, chunk 128;
   recurrentgemma-9b: B 2, S 4096, D 4096) and at the prefill_32k length
   (B 1 and B 4, S 32768). Times are medians of CUDA-event-timed calls
   after a warm-up; the bound is the larger of the bytes over 3.35 TB/s
   and the operations over 67 TFLOP/s in fp32 or 989 TFLOP/s in bf16 (H100
   SXM data sheet; bf16 attention and SSD inputs take the bf16 rate, as
   their kernels run on the tensor cores); attention's library yardstick is
   ``scaled_dot_product_attention`` where it computes the same function
   (no soft cap; a window as a dense boolean mask).
2. paths, at full width (B = 256, T = H = 4096: 16 ticks, 20 SGLD steps,
   8 chains, minibatch 64):
   - slice: ``env.run`` with the FGTS.CDB policy on a pooled ``ModelPool``
     (one retirement mid-run, the per-tick chain energy as ``aux_fn``),
     then a second run with ``delay=2`` and a per-request ``pref_fn``;
   - autopilot: ``env.run`` with ``autopilot.wrap`` over the pooled FGTS
     policy (the configuration of ``benchmarks/bench_autopilot.py``), a
     dominated overpriced arm and one arrival at tick 4;
   - mixed: ``mixed_feedback_policy`` for 16 ticks of act -> BTL feedback
     -> update -> ``inject_clicks`` on half of each batch, with the mixed
     energy trace;
   - ccft: query tokens -> ``EncoderConfig()`` (random weights from a
     seed) -> the RouterBench model embeddings in all four weightings and
     the online env (4096 queries, d = 256 + 14) -> ``env.run`` over FGTS;
     then MixInstruct (1200 queries) -> eq. 6 embeddings -> ``env.run``.
     The encoder alone is timed per 256-query batch;
   - lm: mamba2-1.3b and recurrentgemma-9b at their full configs (bf16,
     random weights made on the card from the seed): B 2 prompts of
     S 4096 random tokens -> ``lm.prefill`` -> 8 greedy
     ``lm.decode_step``s. The launch counts must be exact per prefill
     (48 ``ssd_scan``; 26 ``rglru_scan`` and 12 ``flash_attention``) and
     untouched by decode; one more prefill and two more decode steps run
     under the profiler for the idle share, kernels per prefill or token
     and each kernel's share of the prefill.
   Each run resets the launch counts just before it and reads them just
   after: every kernel of its path must have launched (attention exactly
   once per layer per encode batch). Two more ticks of each loop (and two
   encode batches) run under ``torch.profiler`` (device activity only) for
   the device busy time per tick, its idle share against the unprofiled
   run's ms per tick and the kernels per tick.
3. card vs CPU: 4 ticks at full width on the card and on the CPU (plain
   versions) from one numpy-made draw set, for the FGTS slice, for the
   autopilot (a control tick every 2 acts) and for the ccft path (whose
   embeddings, from the same weights and tokens, must agree to atol 1e-5
   first); routed pairs equal outside near-ties, final chains to rtol
   1e-4, controller counters and flags equal, lambda and the cost EMA to
   rtol 1e-5. Then each LM at full width in fp32 at a cut depth (mamba2
   2 layers, recurrentgemma 3), B 2 x S 500, prefill and 4 decode steps:
   logits within 1e-4 of max |logit|, greedy tokens equal outside
   near-ties, cache leaves within 1e-4 of their largest magnitude,
   ``slot_pos`` equal.

Before the last line it prints the kernels line and the card's name and
power limit; the last line is the device record. Any failed check exits
non-zero; without a CUDA card the script fails.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, data sheet
FP32_FLOP_PER_S = 67e12          # H100 SXM, fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12         # H100 SXM, bf16 tensor cores, dense
NEAR_TIE = 1e-5
# the kernels of the FGTS slice's path (the sync and delay2_pref runs)
SLICE_KERNELS = ("dueling_select", "sgld_potential_fwd", "sgld_potential_grad")


class CheckFailed(AssertionError):
    pass


def check(ok, what):
    if not ok:
        raise CheckFailed(what)


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound(nbytes, flops, flop_per_s=FP32_FLOP_PER_S):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def time_ms(fn, runs=5, calls=20, warmup=3):
    """Per-call time of ``fn``: CUDA events around ``calls`` back-to-back
    calls, divided by ``calls``; the median of ``runs`` such runs after a
    warm-up. Host overhead that outlasts the device work shows here."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def _kernel_events(prof):
    """(name, device us, launches) of every device kernel in a profile
    (events on the device only, so a host op and its kernel are not both
    counted)."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            out.append((e.key, us, e.count))
    return out


def device_ms(fn, calls=20, attempts=3):
    """Device time per call of ``fn`` (all the kernels it launches) from
    ``torch.profiler``'s CUDA activity. A profile that records no device
    activity (seen once in a run of this script on an H100) is taken
    again, up to ``attempts`` times; None when none records any."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(us for _, us, _ in _kernel_events(prof))
        if total > 0:
            return total / calls / 1e3
    return None


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def select_scores(x, a, th, tilt, mask):
    """The plain version's (2, B, K) scores after tilt and mask."""
    import torch
    from repro_torch.kernels import dueling_score as ds
    s = ds.dueling_score_plain(x, a, th)
    if tilt is not None:
        s = s - torch.atleast_2d(tilt)[None]
    if mask is not None:
        s = torch.where(torch.atleast_2d(mask)[None], s, -torch.inf)
    return s


def top2_gap(s):
    """Per row: top-1 minus top-2 (inf when fewer than two are finite)."""
    import torch
    if s.shape[-1] < 2:
        return torch.full(s.shape[:-1], torch.inf, device=s.device)
    v = torch.topk(s, 2, dim=-1).values
    gap = v[..., 0] - v[..., 1]
    return torch.where(torch.isfinite(v[..., 1]), gap, torch.inf)


def compare_pairs(x, a, th, tilt, mask, distinct, k_pair, p_pair):
    """(mismatches outside near-ties, near-tie mismatches, max abs score
    difference at the chosen arms)."""
    import torch
    s = select_scores(x, a, th, tilt, mask)
    scale = torch.nan_to_num(s.abs(), posinf=0.0, neginf=0.0).max()
    thr = NEAR_TIE * float(scale)
    (k1, k2), (p1, p2) = [(u.long(), v.long()) for u, v in (k_pair, p_pair)]
    s2 = s[1]
    if distinct:
        cols = torch.arange(a.shape[0], device=x.device)
        s2 = torch.where(cols[None] == p1[:, None], -torch.inf, s2)
    tie = (top2_gap(s[0]) <= thr) | (top2_gap(s2) <= thr)
    bad = (k1 != p1) | (k2 != p2)
    pick = lambda v, i: torch.gather(v, 1, i[:, None])[:, 0]
    err = torch.nan_to_num(torch.stack([
        (pick(s[0], k1) - pick(s[0], p1)).abs(),
        (pick(s[1], k2) - pick(s[1], p2)).abs()]), nan=0.0, posinf=0.0)
    return int((bad & ~tie).sum()), int((bad & tie).sum()), float(err.max())


def select_case(name, b, k, d, gen, dev, *, mask_kind=None, tilt_kind=None,
                distinct=True, live=None, dup=False, timed=False):
    """One selection case against the plain version. ``dup`` copies the
    first half of the arms into the second, so every row's maximum is an
    exact tie that must go to the first copy."""
    import torch
    from repro_torch.kernels import dueling_score as ds
    x = torch.randn((b, d), generator=gen, device=dev)
    a = torch.randn((k, d), generator=gen, device=dev)
    if dup:
        a[k // 2:2 * (k // 2)] = a[:k // 2]
    th = torch.randn((2, d), generator=gen, device=dev)
    mask = None
    if mask_kind == "k":
        mask = torch.arange(k, device=dev) < (live or k)
    elif mask_kind == "bk":
        mask = torch.rand((b, k), generator=gen, device=dev) > 0.3
        mask[0] = False                               # all inactive
        mask[1] = False
        mask[1, k - 1] = True                         # single survivor
    tilt = None
    if tilt_kind == "k":
        tilt = 0.3 * torch.rand((k,), generator=gen, device=dev)
    elif tilt_kind == "bk":
        tilt = 0.3 * torch.rand((b, k), generator=gen, device=dev)
    kw = dict(tilt=tilt, mask=mask, distinct=distinct)
    kp = ds.dueling_select(x, a, th, **kw)
    torch.cuda.synchronize()
    pp = ds.dueling_select_plain(x, a, th, **kw)
    bad, ties, err = compare_pairs(x, a, th, tilt, mask, distinct, kp, pp)
    out = dict(case=name, B=b, K=k, d=d, mismatches=bad, near_ties=ties,
               max_abs_err=err)
    if mask_kind == "bk" and k > 1:
        check((kp[0][0].item(), kp[1][0].item()) == (0, 0),
              f"{name}: all-inactive row must route (0, 0)")
        check(kp[0][1].item() == kp[1][1].item() == k - 1,
              f"{name}: single survivor must duel itself")
    if dup:
        check(int(kp[0].max()) < k // 2 and int(kp[1].max()) < k // 2,
              f"{name}: a tie went to the second copy")
    check(bad == 0, f"{name}: {bad} pair mismatches outside near-ties")
    if timed:
        nbytes = 4 * (b * d + k * d + 2 * d + 2 * b)
        nbytes += 0 if tilt is None else 4 * tilt.numel()
        nbytes += 0 if mask is None else mask.numel()
        kern = lambda: ds.dueling_select(x, a, th, **kw)
        plain = lambda: ds.dueling_select_plain(x, a, th, **kw)
        out["ms"], out["plain_ms"] = time_ms(kern), time_ms(plain)
        out["device_ms"], out["plain_device_ms"] = (device_ms(kern),
                                                    device_ms(plain))
        out["bound_ms"], out["bound_by"] = bound(nbytes, 6.0 * b * k * d)
    return out


def sgld_case(name, c, m, k, d, n, gen, dev, *, j=1, ties=False,
              timed=False):
    import torch
    from repro_torch.kernels import sgld_update as su
    x = torch.randn((n, d), generator=gen, device=dev)
    a1 = torch.randint(0, k, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    a2 = (a1 + torch.randint(1, max(k, 2), (n,), generator=gen, device=dev,
                             dtype=torch.int32)) % k
    y = torch.where(torch.rand((n,), generator=gen, device=dev) < 0.5, 1.0,
                    -1.0)
    grid = torch.tensor([0.0, 0.5, 2.0], device=dev)
    pref = grid[torch.randint(0, 3, (n,), generator=gen, device=dev)]
    a_emb = torch.randn((k, d), generator=gen, device=dev)
    if ties:
        a_emb[k // 2:2 * (k // 2)] = a_emb[:k // 2]
    mask = torch.arange(k, device=dev) < max(1, (11 * k) // 16)
    costs = torch.rand((k,), generator=gen, device=dev)
    rows = torch.randint(0, n, (c, m), generator=gen, device=dev)
    valid = (torch.rand((c, m), generator=gen, device=dev) < 0.9).float()
    theta = torch.randn((c, d), generator=gen, device=dev)
    g = 4096.0 / valid.sum(-1).clamp_min(1.0)
    ops = (theta, x, a1, a2, y, pref, rows, valid, a_emb, mask, costs)
    kw = dict(j=j, eta=8.0, mu=0.2)
    u_k = su.potential_rows(*ops, **kw)
    g_k = su.potential_grad_rows(*ops, g, **kw)
    torch.cuda.synchronize()
    u_p = su.potential_rows(*ops, **kw, plain=True)
    g_p = su.potential_grad_rows(*ops, g, **kw, plain=True)
    du = float((u_k - u_p).abs().max())
    dg = float((g_k - g_p).abs().max())
    su_ = float(u_p.abs().max())
    sg_ = float(g_p.abs().max())
    rel = lambda err, scale: err / scale if scale > 1e-6 else None
    out = dict(case=name, C=c, m=m, K=k, d=d, j=j,
               fwd_max_abs_err=du, fwd_max_rel_err=rel(du, su_),
               grad_max_abs_err=dg, grad_max_rel_err=rel(dg, sg_))
    check(bool(torch.isfinite(u_k).all() and torch.isfinite(g_k).all()),
          f"{name}: non-finite kernel output")
    check(du <= 1e-5 * su_ + 1e-6, f"{name}: potential off by {du}")
    check(dg <= 1e-4 * sg_ + 1e-5, f"{name}: gradient off by {dg}")
    # one cluster launch per call, summed in a fixed order: bitwise the
    # same from call to call
    check(all(torch.equal(su.potential_rows(*ops, **kw), u_k) and
              torch.equal(su.potential_grad_rows(*ops, g, **kw), g_k)
              for _ in range(3)), f"{name}: repeated calls differ")
    out["plan"] = su.fgts_plan(m, k, d)
    if timed:
        rows_bytes = c * m * (4 * d + 4 * 4 + 8 + 4)
        arm_bytes = 4 * k * d + 5 * k + 4 * c * d
        score_flops = 4.0 * c * m * k * d
        fns = dict(
            fwd=lambda: su.potential_rows(*ops, **kw),
            fwd_plain=lambda: su.potential_rows(*ops, **kw, plain=True),
            grad=lambda: su.potential_grad_rows(*ops, g, **kw),
            grad_plain=lambda: su.potential_grad_rows(*ops, g, **kw,
                                                      plain=True))
        for key, fn in fns.items():
            out[key + "_ms"] = time_ms(fn)
            out[key + "_device_ms"] = device_ms(fn)
        out["fwd_bound_ms"], out["fwd_bound_by"] = bound(
            rows_bytes + arm_bytes + 4 * c, score_flops)
        out["grad_bound_ms"], out["grad_bound_by"] = bound(
            rows_bytes + arm_bytes + 4 * c + 4 * c * d,
            score_flops + 7.0 * c * m * d)
    return out


def near_tie_pairs(s):
    """(K, K) bool: arm pairs whose scores (C, K) lie within NEAR_TIE *
    max|s| in some sample (the diagonal included)."""
    thr = NEAR_TIE * float(s.abs().max())
    return ((s[:, :, None] - s[:, None, :]).abs() <= thr).any(dim=0)


def score_case(name, b, k, d, j, gen, dev, *, posterior=False, live=None,
               dup=False, zeros=False, timed=False):
    """One ``dueling_score`` case against the plain version: scores to
    1e-5 of max|s|; ``dup`` copies arm 0 into the last slot (bitwise equal
    columns), ``zeros`` zeroes arm 1 and query row 0 (scores 0 through the
    1e-24 clamp). ``posterior`` drives ``posterior_scores`` (the all-ones
    query, b = 1) and holds the dominance matrices of the first ``live``
    arms equal outside near-tied pairs."""
    import torch
    from repro_torch.autopilot import dominance
    from repro_torch.kernels import dueling_score as ds
    a = torch.randn((k, d), generator=gen, device=dev)
    th = torch.randn((j, d), generator=gen, device=dev)
    if dup:
        a[k - 1] = a[0]
    if zeros:
        a[1] = 0.0
    if posterior:
        kern = lambda: ds.posterior_scores(a, th)
        plain = lambda: ds.posterior_scores_plain(a, th)
    else:
        x = torch.randn((b, d), generator=gen, device=dev)
        if zeros:
            x[0] = 0.0
        kern = lambda: ds.dueling_score(x, a, th)
        plain = lambda: ds.dueling_score_plain(x, a, th)
    s_k = kern()
    torch.cuda.synchronize()
    s_p = plain()
    scale = float(s_p.abs().max())
    err = float((s_k - s_p).abs().max())
    out = dict(case=name, B=b, K=k, d=d, J=j, max_abs_err=err,
               max_rel_err=err / scale if scale > 0 else None)
    check(bool(torch.isfinite(s_k).all()), f"{name}: non-finite scores")
    check(err <= NEAR_TIE * scale, f"{name}: scores off by {err}")
    if dup:
        check(torch.equal(s_k[..., k - 1], s_k[..., 0]),
              f"{name}: duplicated arms not bitwise equal")
    if zeros:
        check(not bool(s_k[..., 1].any()), f"{name}: zero arm scored")
        if not posterior:
            check(not bool(s_k[:, 0].any()), f"{name}: zero query scored")
    # one launch, every output summed in one fixed order: bitwise the same
    # from call to call
    check(all(torch.equal(kern(), s_k) for _ in range(3)),
          f"{name}: repeated calls differ")
    out["plan"] = ds.score_plan(b, k, j, d)[0]
    if posterior:
        live = live or k
        dk = dominance.win_matrix(s_k[:, :live])
        dp = dominance.win_matrix(s_p[:, :live])
        tie = near_tie_pairs(s_p[:, :live])
        diff = dk != dp
        out.update(dominance_mismatches=int((diff & ~tie).sum()),
                   dominance_near_tie_mismatches=int((diff & tie).sum()),
                   near_tied_pairs=int(tie.sum()) - live)
        check(out["dominance_mismatches"] == 0,
              f"{name}: dominance differs outside near-ties")
    if timed:
        nbytes = 4 * (b * d + k * d + j * d + j * b * k)
        out["ms"], out["plain_ms"] = time_ms(kern), time_ms(plain)
        out["device_ms"], out["plain_device_ms"] = (device_ms(kern),
                                                    device_ms(plain))
        out["bound_ms"], out["bound_by"] = bound(nbytes,
                                                 2.0 * (j + 1) * b * k * d)
    return out


def mixed_case(name, c, m, k, d, n, gen, dev, *, kind="half", timed=False):
    """One case of the mixed SGLD kernels against their plain versions.
    ``kind``: "half" (duels and clicks), "duels", "clicks", "invalid"
    (valid = 0 on every other minibatch slot) or "self" (a1 == a2 on every
    row)."""
    import torch
    from repro_torch.kernels import sgld_update as su
    x = torch.randn((n, d), generator=gen, device=dev)
    a1 = torch.randint(0, k, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    a2 = a1.clone() if kind == "self" else (a1 + torch.randint(
        1, max(k, 2), (n,), generator=gen, device=dev,
        dtype=torch.int32)) % k
    coin = torch.rand((n,), generator=gen, device=dev) < 0.5
    duel = {"duels": torch.ones_like(coin),
            "clicks": torch.zeros_like(coin)}.get(kind, coin)
    u = torch.rand((n,), generator=gen, device=dev) < 0.5
    y = torch.where(duel, torch.where(u, 1.0, -1.0), u.float())
    rows = torch.randint(0, n, (c, m), generator=gen, device=dev)
    valid = (torch.rand((c, m), generator=gen, device=dev) < 0.9).float()
    if kind == "invalid":
        valid[:, ::2] = 0.0
    a_emb = torch.randn((k, d), generator=gen, device=dev)
    theta = torch.randn((c, d), generator=gen, device=dev)
    g = 4096.0 / valid.sum(-1).clamp_min(1.0)
    ops = (theta, x, a1, a2, y, duel.float(), rows, valid, a_emb)
    u_k = su.mixed_potential_rows(*ops, eta=8.0)
    g_k = su.mixed_potential_grad_rows(*ops, g, eta=8.0)
    torch.cuda.synchronize()
    u_p = su.mixed_potential_rows(*ops, eta=8.0, plain=True)
    g_p = su.mixed_potential_grad_rows(*ops, g, eta=8.0, plain=True)
    du = float((u_k - u_p).abs().max())
    dg = float((g_k - g_p).abs().max())
    su_, sg_ = float(u_p.abs().max()), float(g_p.abs().max())
    rel = lambda err, scale: err / scale if scale > 1e-6 else None
    out = dict(case=name, C=c, m=m, K=k, d=d, kind=kind,
               fwd_max_abs_err=du, fwd_max_rel_err=rel(du, su_),
               grad_max_abs_err=dg, grad_max_rel_err=rel(dg, sg_))
    check(bool(torch.isfinite(u_k).all() and torch.isfinite(g_k).all()),
          f"mixed {name}: non-finite kernel output")
    check(du <= 1e-5 * su_ + 1e-6, f"mixed {name}: potential off by {du}")
    check(dg <= 1e-4 * sg_ + 1e-5, f"mixed {name}: gradient off by {dg}")
    # one cluster launch per call, summed in a fixed order: bitwise the same
    # from call to call
    check(all(torch.equal(su.mixed_potential_rows(*ops, eta=8.0), u_k) and
              torch.equal(su.mixed_potential_grad_rows(*ops, g, eta=8.0),
                          g_k) for _ in range(3)),
          f"mixed {name}: repeated calls differ")
    out["plan"] = su.mixed_plan(m, d)
    if timed:
        # each gathered row once (x, four per-row scalars, its index and
        # valid flag), each arm it scores once, theta, and the output
        r = rows.long()
        scored = torch.cat([a1[r].flatten(), a2[r][duel[r]].flatten()])
        n_scores = scored.numel()
        arm_bytes = 4 * d * torch.unique(scored).numel() + 4 * c * d
        rows_bytes = c * m * (4 * d + 4 * 4 + 8 + 4)
        score_flops = 7.0 * d * n_scores
        fns = dict(
            fwd=lambda: su.mixed_potential_rows(*ops, eta=8.0),
            fwd_plain=lambda: su.mixed_potential_rows(*ops, eta=8.0,
                                                      plain=True),
            grad=lambda: su.mixed_potential_grad_rows(*ops, g, eta=8.0),
            grad_plain=lambda: su.mixed_potential_grad_rows(
                *ops, g, eta=8.0, plain=True))
        for key, fn in fns.items():
            out[key + "_ms"] = time_ms(fn)
            out[key + "_device_ms"] = device_ms(fn)
        out["fwd_bound_ms"], out["fwd_bound_by"] = bound(
            rows_bytes + arm_bytes + 4 * c, score_flops)
        out["grad_bound_ms"], out["grad_bound_by"] = bound(
            rows_bytes + arm_bytes + 4 * c + 4 * c * d,
            score_flops + 5.0 * c * m * d)
    return out


ATTN_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}
# SDPA against the kernel: loose enough for a TF32 or bf16-P backend; a
# wrong mask or scale would be off by 0.1 or more
LIB_TOL = {"float32": 1e-2, "bfloat16": 5e-2}


def attn_case(name, b, h, kv, s, t, d, gen, dev, *, dtype="float32",
              causal=True, window=0, cap=0.0, strided=False, unaligned=False,
              timed=False):
    """One ``flash_attention`` case against the plain version on the card:
    |kernel - plain| <= atol + rtol * |plain| elementwise (fp32 2e-5, bf16
    2e-2). ``strided`` passes q, k, v as ``transpose(1, 2)`` views of
    (B,S,H,D) tensors, as the model does; ``unaligned`` (fp32) as views one
    element off a 16-byte boundary, which the SIMT kernel loads with 4-byte
    copies. Timed cases add the bound (4 D
    operations per live (row, key) pair, counted from the mask; q, k, v and
    o moved once; bf16 against the bf16 tensor-core peak) and, where no
    soft cap is set, the time of ``scaled_dot_product_attention`` on the
    same inputs as the library yardstick (within ``LIB_TOL`` of the kernel:
    the same function), with a window as a dense boolean mask from
    ``live_mask``."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    dt = getattr(torch, dtype)
    q_shape, kv_shape = (((b, s, h, d), (b, t, kv, d)) if strided
                         else ((b, h, s, d), (b, kv, t, d)))
    q = torch.randn(q_shape, generator=gen, device=dev).to(dt)
    k = torch.randn(kv_shape, generator=gen, device=dev).to(dt)
    v = torch.randn(kv_shape, generator=gen, device=dev).to(dt)
    if strided:
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if unaligned:
        def off(x):
            buf = x.new_empty(x.numel() + 1)
            y = buf[1:].view(x.shape)
            y.copy_(x)
            return y
        q, k, v = off(q), off(k), off(v)
    kw = dict(causal=causal, window=window, softcap=cap)
    o_k = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    o_p = fa.flash_attention_plain(q, k, v, **kw)
    rtol, atol = ATTN_TOL[dtype]
    diff = (o_k.float() - o_p.float()).abs()
    out = dict(case=name, B=b, H=h, KV=kv, S=s, T=t, D=d, dtype=dtype,
               causal=causal, window=window, softcap=cap, strided=strided,
               unaligned=unaligned, max_abs_err=float(diff.max()))
    check(bool(torch.isfinite(o_k.float()).all()),
          f"attn {name}: non-finite kernel output")
    check(bool((diff <= atol + rtol * o_p.float().abs()).all()),
          f"attn {name}: off by {out['max_abs_err']}")
    if window and s > t + window - 1:
        dead = o_k[:, :, t + window - 1:].float()
        mean_v = v.float().mean(dim=2).repeat_interleave(h // kv, dim=1)
        out["dead_rows"] = s - (t + window - 1)
        out["dead_rows_max_abs_err"] = float(
            (dead - mean_v[:, :, None]).abs().max())
        check(out["dead_rows_max_abs_err"] <= atol + rtol,
              f"attn {name}: a row with no live key is not the mean of v")
    del o_p, diff
    if timed:
        mask = fa.live_mask(s, t, causal=causal, window=window, device=dev)
        live = int(mask.sum())
        nbytes = (q.numel() * 2 + k.numel() * 2) * q.element_size()
        peak = BF16_FLOP_PER_S if dtype == "bfloat16" else FP32_FLOP_PER_S
        kern = lambda: fa.flash_attention(q, k, v, **kw)
        plain = lambda: fa.flash_attention_plain(q, k, v, **kw)
        out["ms"], out["plain_ms"] = time_ms(kern), time_ms(plain)
        out["device_ms"], out["plain_device_ms"] = (device_ms(kern),
                                                    device_ms(plain))
        out["bound_ms"], out["bound_by"] = bound(
            nbytes, 4.0 * b * h * live * d, peak)
        out["library_ms"] = None
        if not cap:
            sdpa_kw = (dict(is_causal=causal) if not window
                       else dict(attn_mask=mask))
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, enable_gqa=h != kv, **sdpa_kw)
            o_l = sdpa()
            out["library_max_abs_err"] = float((o_l.float()
                                                - o_k.float()).abs().max())
            check(out["library_max_abs_err"] <= LIB_TOL[dtype],
                  f"attn {name}: SDPA computes another function")
            del o_l
            out["library_mask"] = ("dense bool" if window else
                                   "is_causal" if causal else "none")
            out["library_ms"] = time_ms(sdpa)
            out["library_device_ms"] = device_ms(sdpa)
    return out


def attn_cases(gen, dev):
    """The attn family: the reference's five test shapes in fp32 and bf16,
    rows with no live key, bf16 strided views, ragged S/T at D 256, D 32
    with GQA, then the path's and the LM configs' heads."""
    cases = []
    for dtype in ("float32", "bfloat16"):
        for i, (b, h, kv, s, t, d, causal, window, cap) in enumerate([
                (2, 4, 2, 256, 256, 64, True, 0, 0.0),
                (1, 4, 1, 200, 200, 64, True, 64, 0.0),
                (2, 2, 2, 128, 384, 128, False, 0, 50.0),
                (1, 8, 8, 64, 64, 128, True, 0, 30.0),
                (1, 2, 1, 384, 130, 64, True, 0, 0.0)]):
            cases.append(attn_case(f"ref{i}_{dtype}", b, h, kv, s, t, d, gen,
                                   dev, dtype=dtype, causal=causal,
                                   window=window, cap=cap))
    bf = dict(dtype="bfloat16")
    cases += [
        # the fp32 kernel's double buffer over many kv tiles, ragged S/T,
        # 16-key tiles at D 128, and its 4-byte copies for unaligned views
        attn_case("fp32_double_buffer_ragged", 2, 4, 2, 333, 517, 64, gen,
                  dev, causal=False),
        attn_case("fp32_d128_ragged_window", 1, 4, 2, 300, 461, 128, gen,
                  dev, window=100),
        attn_case("fp32_d256_cap", 1, 2, 2, 70, 90, 256, gen, dev,
                  causal=False, window=40, cap=30.0),
        attn_case("fp32_unaligned", 2, 4, 2, 90, 150, 64, gen, dev,
                  causal=False, window=30, unaligned=True),
    ]
    cases += [
        attn_case("no_live_key_rows", 1, 2, 1, 300, 100, 64, gen, dev,
                  causal=True, window=4),
        attn_case("no_live_key_rows_bf16", 1, 4, 2, 300, 100, 256, gen, dev,
                  causal=True, window=4, **bf),
        attn_case("strided_bf16", 2, 8, 2, 300, 300, 128, gen, dev,
                  strided=True, **bf),
        attn_case("strided_window_cap_bf16", 2, 16, 8, 300, 300, 256, gen,
                  dev, window=100, cap=50.0, strided=True, **bf),
        attn_case("ragged_d256_bf16", 1, 4, 2, 300, 130, 256, gen, dev, **bf),
        attn_case("ragged_d256_window_bf16", 2, 4, 1, 300, 130, 256, gen,
                  dev, causal=False, window=64, **bf),
        attn_case("d32_gqa_bf16", 1, 8, 2, 300, 300, 32, gen, dev, **bf),
        # the encoder's attention at the ccft path's batch: EncoderConfig()
        attn_case("main", 256, 4, 4, 64, 64, 64, gen, dev, causal=False,
                  timed=True),
        # qwen2-7b's heads
        attn_case("bench", 1, 28, 4, 2048, 2048, 128, gen, dev, timed=True),
        attn_case("qwen2_bf16", 1, 28, 4, 2048, 2048, 128, gen, dev,
                  timed=True, **bf),
        # gemma2-9b's heads: soft cap, and a window that bites
        attn_case("gemma2_bf16", 1, 16, 8, 8192, 8192, 256, gen, dev,
                  window=4096, cap=50.0, **bf),
        # recurrentgemma-9b's local layers at the lm path's prefill
        attn_case("recurrentgemma_bf16", 2, 16, 1, 4096, 4096, 256, gen, dev,
                  window=2048, timed=True, **bf),
    ]
    return cases


SSD_TOL, RGLRU_TOL = 2e-4, 1e-5       # the reference's kernel tolerances


def within(got, want, tol):
    """max |got - want| and whether every element is within tol + tol *
    |want| (rtol = atol = tol, as the reference's assert_allclose)."""
    diff = (got.float() - want.float()).abs()
    return float(diff.max()), bool((diff <= tol + tol * want.float().abs())
                                   .all())


def ssd_case(name, b, s, h, p, n, chunk, gen, dev, *, dtype="float32",
             h0=False, strided=False, timed=False):
    """One ``ssd_scan`` case against the plain version on the card (y and
    h_last to rtol = atol = 2e-4). Inputs as the reference's test makes
    them: x, B, C normal, dt = softplus(normal), log_a = -0.1 dt.
    ``strided`` passes x, B and C as column slices of one (B,S,H*P+2N)
    tensor, as the model does. Timed cases add the bound: the operations
    the function needs, for a chunk of l live steps l (l + 1) N for the
    causal half of C.B^T once per (batch, chunk) (B and C are shared by
    the heads), and per (batch*head, chunk) l (l + 1) P for the causal
    W x plus 2 l N P each for C.state and the state update; bytes: x, B,
    C, log_a, dt and h0 read once, y and h_last written once; bf16 inputs
    against the bf16 tensor-core peak (the Hopper kernel's route), fp32
    against the CUDA cores'. ``kernel`` records which kernel the wrapper's
    rule picked."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    dt_ = getattr(torch, dtype)
    rn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    if strided:
        xbc = rn(b, s, h * p + 2 * n).to(dt_)
        x = xbc[..., :h * p].reshape(b, s, h, p)
        bt, ct = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    else:
        x, bt, ct = (rn(b, s, h, p).to(dt_), rn(b, s, n).to(dt_),
                     rn(b, s, n).to(dt_))
    dt = torch.nn.functional.softplus(rn(b, s, h))
    log_a = -0.1 * dt
    hh = rn(b, h, p, n) if h0 else None
    args = (x, bt, ct, log_a, dt, hh)
    y, hl = ss.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    py, phl = ss.ssd_scan_plain(*args, chunk=chunk)
    ey, oky = within(y, py, SSD_TOL)
    eh, okh = within(hl, phl, SSD_TOL)
    out = dict(case=name, B=b, S=s, H=h, P=p, N=n, chunk=chunk, dtype=dtype,
               h0=h0, strided=strided,
               kernel="sm90" if ss.uses_sm90(dt_, p, n, chunk) else "simt",
               max_abs_err=max(ey, eh), h_last_max_abs_err=eh)
    check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(hl).all()),
          f"ssd {name}: non-finite kernel output")
    check(oky and okh, f"ssd {name}: off by {ey} (y), {eh} (h_last)")
    del py, phl
    if timed:
        lens = [min(chunk, s - c) for c in range(0, s, chunk)]
        flops = float(sum(b * l * (l + 1) * n
                          + b * h * (l * (l + 1) * p + 4 * l * n * p)
                          for l in lens))
        el = x.element_size()
        nbytes = (el * (b * s * h * p + 2 * b * s * n) + 4 * 2 * b * s * h
                  + 4 * b * s * h * p + 4 * b * h * p * n * (1 + bool(h0)))
        kern = lambda: ss.ssd_scan(*args, chunk=chunk)
        plain = lambda: ss.ssd_scan_plain(*args, chunk=chunk)
        out["ms"], out["device_ms"] = time_ms(kern), device_ms(kern)
        out["plain_ms"] = time_ms(plain, runs=3, calls=2, warmup=1)
        out["plain_device_ms"] = device_ms(plain, calls=2)
        peak = BF16_FLOP_PER_S if dtype == "bfloat16" else FP32_FLOP_PER_S
        out["bound_ms"], out["bound_by"] = bound(nbytes, flops, peak)
        out["library_ms"] = None
    return out


def ssd_refuses_misaligned(dev):
    """The Hopper kernels load bf16 x, B and C through TMA: slices of a
    (B,S,H*P+2N) tensor one element off a 16-byte boundary, or with a row
    stride that is not a multiple of 8 elements, raise ValueError and
    launch nothing."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    b, s, h, p, n = 1, 64, 2, 64, 128
    width = h * p + 2 * n
    xbc = torch.zeros((b, s, width + 4), device=dev, dtype=torch.bfloat16)
    dt = torch.ones((b, s, h), device=dev)
    before, refused = ss.ssd_scan.launches, 0
    for t in (xbc[..., 1:1 + width], xbc[..., :width]):
        x = t[..., :h * p].unflatten(-1, (h, p))
        try:
            ss.ssd_scan(x, t[..., h * p:h * p + n], t[..., h * p + n:],
                        -0.1 * dt, dt)
        except ValueError:
            refused += 1
    check(refused == 2 and ss.ssd_scan.launches == before,
          "ssd: a misaligned bf16 slice was not refused")
    return refused


def rglru_case(name, b, s, d, gen, dev, *, h0=False, timed=False):
    """One ``rglru_scan`` case against the plain version on the card (h
    and h_last to rtol = atol = 1e-5); log_a = -0.1 |normal| and x normal,
    as the reference's test. Timed cases add the bound: 12 bytes per
    element (log_a and x read, h written) plus h0 and h_last, against ~8
    operations per element."""
    import torch
    from repro_torch.kernels import rglru_scan as rg
    log_a = -0.1 * torch.randn((b, s, d), generator=gen, device=dev).abs()
    x = torch.randn((b, s, d), generator=gen, device=dev)
    hh = torch.randn((b, d), generator=gen, device=dev) if h0 else None
    h, hl = rg.rglru_scan(log_a, x, hh)
    torch.cuda.synchronize()
    ph, phl = rg.rglru_scan_plain(log_a, x, hh)
    e1, ok1 = within(h, ph, RGLRU_TOL)
    e2, ok2 = within(hl, phl, RGLRU_TOL)
    out = dict(case=name, B=b, S=s, D=d, h0=h0, max_abs_err=max(e1, e2),
               kernel="sm90" if rg.uses_tma(log_a, x) else "simt")
    check(bool(torch.isfinite(h).all()), f"rglru {name}: non-finite output")
    check(ok1 and ok2, f"rglru {name}: off by {e1} (h), {e2} (h_last)")
    del ph, phl
    if timed:
        nbytes = 12 * b * s * d + 4 * b * d * (1 + bool(h0))
        kern = lambda: rg.rglru_scan(log_a, x, hh)
        plain = lambda: rg.rglru_scan_plain(log_a, x, hh)
        out["ms"], out["device_ms"] = time_ms(kern), device_ms(kern)
        out["plain_ms"] = time_ms(plain, runs=3, calls=1, warmup=1)
        out["plain_device_ms"] = device_ms(plain, calls=1)
        out["bound_ms"], out["bound_by"] = bound(nbytes, 8.0 * b * s * d)
        out["library_ms"] = None
    return out


def scan_cases(gen, dev):
    """The ssd and rglru families: the reference's test shapes
    (``tests/test_kernels.py:43-67``), the edges (ragged S, S < chunk,
    S = 1, h0, bf16 x/B/C, strided views), then the LM path's shapes
    (``main``: mamba2-1.3b's and recurrentgemma-9b's B 2 x S 4096 prefill,
    in the path's bf16 for the SSD, and in fp32 as ``main_fp32``) and the
    prefill_32k length (``bench``)."""
    ssd = [ssd_case(f"ref{i}", b, s, h, p, n, c, gen, dev, h0=h0)
           for i, (b, s, h, p, n, c, h0) in enumerate([
               (2, 200, 4, 64, 32, 64, True), (1, 256, 2, 32, 64, 128, False),
               (2, 96, 8, 64, 128, 32, True)])]
    ssd_refuses_misaligned(dev)
    bf = dict(dtype="bfloat16")
    ssd += [
        ssd_case("ragged_h0_bf16", 2, 300, 8, 64, 128, 128, gen, dev,
                 h0=True, **bf),
        ssd_case("s_below_chunk_strided", 2, 100, 8, 64, 128, 128, gen, dev,
                 strided=True),
        ssd_case("s1_h0", 2, 1, 4, 64, 128, 128, gen, dev, h0=True),
        # the Hopper kernels' edges: S < chunk, S = 1, the ring turning
        # over many chunks with h0 and strided slices
        ssd_case("s_below_chunk_strided_bf16", 2, 100, 8, 64, 128, 128, gen,
                 dev, strided=True, **bf),
        ssd_case("s1_h0_bf16", 2, 1, 4, 64, 128, 128, gen, dev, h0=True,
                 **bf),
        ssd_case("ring_h0_strided_bf16", 1, 1000, 4, 64, 128, 128, gen, dev,
                 h0=True, strided=True, **bf),
        # bf16 outside the Hopper kernels' tile: the SIMT kernel
        ssd_case("simt_bf16", 2, 200, 4, 64, 32, 64, gen, dev, h0=True,
                 **bf),
        # the path's dtype: mamba2-1.3b's bf16 conv output, sliced
        ssd_case("main", 2, 4096, 64, 64, 128, 128, gen, dev,
                 dtype="bfloat16", strided=True, timed=True),
        ssd_case("main_fp32", 2, 4096, 64, 64, 128, 128, gen, dev,
                 strided=True, timed=True),
        ssd_case("bench", 1, 32768, 64, 64, 128, 128, gen, dev,
                 dtype="bfloat16", strided=True, timed=True),
    ]
    rgl = [rglru_case(f"ref{i}", b, s, d, gen, dev, h0=h0)
           for i, (b, s, d, h0) in enumerate([
               (2, 200, 512, True), (1, 128, 512, False),
               (3, 65, 1024, True)])]
    rgl += [
        rglru_case("d96_ragged", 2, 77, 96, gen, dev),
        rglru_case("s1_h0", 2, 1, 4096, gen, dev, h0=True),
        # B 1, S not a multiple of the ring's 32-step tile; D 98 (no
        # multiple of 4) takes the first kernel
        rglru_case("b1_s_ragged", 1, 1001, 96, gen, dev, h0=True),
        rglru_case("d98_simt", 2, 300, 98, gen, dev, h0=True),
        rglru_case("main", 2, 4096, 4096, gen, dev, timed=True),
        rglru_case("bench", 4, 32768, 4096, gen, dev, timed=True),
    ]
    return ssd, rgl


def phase_kernels(dev, seed):
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sel = [
        select_case("main", 256, 16, 768, gen, dev, mask_kind="k", live=11,
                    timed=True),
        select_case("main_pref_tilt", 256, 16, 768, gen, dev, mask_kind="k",
                    live=11, tilt_kind="bk"),
        select_case("bench", 4096, 1024, 768, gen, dev, timed=True),
        select_case("k1", 64, 1, 768, gen, dev),
        select_case("k_ragged_d_ragged", 100, 37, 100, gen, dev,
                    tilt_kind="k"),
        select_case("row_mask_survivor_inactive", 130, 11, 768, gen, dev,
                    mask_kind="bk", tilt_kind="bk"),
        select_case("row_mask_not_distinct", 130, 11, 768, gen, dev,
                    mask_kind="bk", distinct=False),
        select_case("large_k", 64, 1100, 96, gen, dev, mask_kind="bk"),
        select_case("duplicate_arms_first_index", 256, 16, 768, gen, dev,
                    distinct=False, dup=True),
    ]
    sg = [
        sgld_case("main", 8, 64, 16, 768, 4096, gen, dev, timed=True),
        sgld_case("main_j2", 8, 64, 16, 768, 4096, gen, dev, j=2),
        sgld_case("bench", 8, 1024, 1024, 768, 4096, gen, dev, timed=True),
        sgld_case("tied_maxima", 8, 64, 16, 768, 4096, gen, dev, ties=True),
        sgld_case("k1_ragged", 3, 37, 1, 100, 500, gen, dev),
        # one arm past the Small tile; duplicated arms tying across the
        # Large configuration's 256-arm tiles (150-299 copy 0-149), m not a
        # multiple of the rows per block
        sgld_case("k33_ragged", 3, 45, 33, 100, 500, gen, dev),
        sgld_case("ties_across_tiles", 3, 301, 300, 64, 500, gen, dev,
                  ties=True),
        sgld_case("ties_across_tiles_j2", 3, 301, 300, 64, 500, gen, dev,
                  ties=True, j=2),
    ]
    sc = [
        score_case("main", 1, K_MAX, DIM, 16, gen, dev, posterior=True,
                   live=K_LIVE, timed=True),
        score_case("bench", 4096, 1024, DIM, 2, gen, dev, timed=True),
        score_case("k1_b1_j1", 1, 1, DIM, 1, gen, dev),
        score_case("j17_d100_ragged", 130, 37, 100, 17, gen, dev, dup=True,
                   zeros=True),
        score_case("posterior_duplicate_zero_arm", 1, K_MAX, DIM, 16, gen,
                   dev, posterior=True, dup=True, zeros=True),
        # the two sides of score_plan's cap on B*K*J*d (Small up to 2^27),
        # and Small with ragged d: 16-byte loads at d 100, 4-byte at d 98
        score_case("small_b170", 170, 1024, DIM, 1, gen, dev, dup=True,
                   zeros=True),
        score_case("large_b171", 171, 1024, DIM, 1, gen, dev, dup=True,
                   zeros=True),
        score_case("small_d100_dup_zero", 5, 37, 100, 3, gen, dev, dup=True,
                   zeros=True),
        score_case("small_d98_dup_zero", 5, 37, 98, 3, gen, dev, dup=True,
                   zeros=True),
    ]
    mx = [
        mixed_case("main", 8, 64, K_MAX, DIM, 4096, gen, dev, timed=True),
        mixed_case("bench", 8, 1024, 1024, DIM, 4096, gen, dev, timed=True),
        mixed_case("all_duels", 8, 64, K_MAX, DIM, 4096, gen, dev,
                   kind="duels"),
        mixed_case("all_clicks", 8, 64, K_MAX, DIM, 4096, gen, dev,
                   kind="clicks"),
        mixed_case("invalid_rows", 8, 64, K_MAX, DIM, 4096, gen, dev,
                   kind="invalid"),
        mixed_case("self_duels_ragged", 3, 37, 5, 100, 500, gen, dev,
                   kind="self"),
        # mixed_plan's edges: one row, fewer rows than a cluster's blocks,
        # rows per block no multiple of the group, one chain, and d 98 (the
        # 4-byte loads; d 100 above takes the 16-byte loads)
        mixed_case("m1", 8, 1, K_MAX, DIM, 4096, gen, dev),
        mixed_case("m3", 8, 3, K_MAX, DIM, 4096, gen, dev),
        mixed_case("m45", 8, 45, K_MAX, DIM, 4096, gen, dev),
        mixed_case("c1", 1, 64, K_MAX, DIM, 4096, gen, dev),
        mixed_case("d98_ragged", 3, 37, 5, 98, 500, gen, dev),
    ]
    return (sel, sg, sc, mx, attn_cases(gen, dev)) + scan_cases(gen, dev)


# ---------------------------------------------------------------------------
# phases 2 and 3: the slice
# ---------------------------------------------------------------------------

K_LIVE, K_MAX, DIM, BATCH, HORIZON = 11, 16, 768, 256, 4096
# the autopilot run: benchmarks/bench_autopilot.py:52-53's configuration,
# a dominated overpriced arm and one arrival
AP_KW = dict(every=3, tau=0.75, window=2, quota=0.25, budget=0.35,
             budget_lr=0.5)
BAD, ARRIVAL, ARRIVAL_TICK = 10, 11, 4


def slice_setup(seed, dev, t_total, dominated=False):
    """Synthetic CCFT world from ``seed``: category embeddings of offline
    queries, the arm table through ``ccft.model_embeddings``, a query
    stream and utilities. Built on the CPU and moved to ``dev``, so a card
    run and a CPU run see bitwise the same world. ``dominated`` halves arm
    BAD's skills (arm 0's, halved) and prices it at 10x the median live
    cost."""
    import numpy as np
    import torch
    from repro_torch.core import ccft, fgts, model_pool as mp, policy
    rng = np.random.default_rng(seed)
    n_cat, n_off = 12, 2048
    centers = rng.standard_normal((n_cat, DIM)).astype(np.float32)
    cats = rng.integers(0, n_cat, n_off)
    off = centers[cats] + 0.3 * rng.standard_normal((n_off, DIM))
    xi = ccft.category_embeddings(torch.tensor(off, dtype=torch.float32),
                                  torch.tensor(cats), n_cat)
    skill = rng.random((K_MAX, n_cat)).astype(np.float32)
    costs = np.linspace(0.1, 1.0, K_MAX).astype(np.float32)
    if dominated:
        skill[BAD] = 0.5 * skill[0]
        costs[BAD] = 10.0 * np.median(costs[:K_LIVE])
    a_emb = ccft.model_embeddings(xi, torch.tensor(skill),
                                  "excel_perf_cost").to(dev)
    q_cat = rng.integers(0, n_cat, t_total)
    x = centers[q_cat] + 0.3 * rng.standard_normal((t_total, DIM))
    utils = skill[:, q_cat].T + 0.05 * rng.standard_normal((t_total, K_MAX))
    pool = mp.init_pool(a_emb[:K_LIVE], costs[:K_LIVE], K_MAX, device=dev)
    pool = pool._replace(a_emb=a_emb.contiguous(),
                         costs=torch.tensor(costs, device=dev))
    cfg = fgts.FGTSConfig(n_models=K_MAX, dim=DIM, horizon=HORIZON, eta=8.0,
                          mu=0.2, sgld_steps=20, sgld_eps=5e-4,
                          sgld_minibatch=64, n_chains=8, force_distinct=True)
    from repro_torch.core import env
    envd = env.EnvData(torch.tensor(x, dtype=torch.float32, device=dev),
                       torch.tensor(utils, dtype=torch.float32, device=dev))
    return envd, pool, cfg, policy.fgts_policy(pool, cfg)


def energy_aux(cfg):
    from repro_torch.core import fgts

    def aux(state, a1, a2):
        pool = state.pool
        return fgts.chain_energy(state.inner, pool.a_emb, cfg,
                                 arm_mask=pool.active, costs=pool.costs)
    return aux


def phase_slice(dev, seed):
    import torch
    from repro_torch import kernels
    from repro_torch.core import env, model_pool as mp, regret
    from repro_torch.core.draws import TorchDraws
    envd, pool, cfg, pol = slice_setup(seed, dev, HORIZON)
    n_ticks = HORIZON // BATCH
    sched = mp.schedule([(n_ticks // 2, 3, None, None)], DIM, device=dev)
    grid = torch.tensor([0.0, 0.5, 2.0], device=dev)
    runs = {}
    for label, kw in (
            ("sync", dict()),
            ("delay2_pref", dict(delay=2, pref_fn=lambda s, xb: grid[
                (torch.arange(BATCH, device=dev) + s) % 3]))):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cum, state, energy = env.run(TorchDraws(seed, dev), envd, pol,
                                     batch=BATCH, pool_schedule=sched,
                                     aux_fn=energy_aux(cfg), **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        check(all(counts[k] > 0 for k in SLICE_KERNELS),
              f"slice {label}: a kernel never launched: {counts}")
        check(bool(torch.isfinite(cum).all()) and cum.shape == (HORIZON,),
              f"slice {label}: regret curve not finite / wrong shape")
        check(bool(torch.isfinite(energy).all())
              and energy.shape == (n_ticks, 2, cfg.n_chains),
              f"slice {label}: chain energy not finite / wrong shape")
        check(not bool(state.pool.active[3]) and int(state.inner.t) > 0,
              f"slice {label}: retirement or ring fold missing")
        runs[label] = dict(
            final_regret=float(cum[-1]), slope_ratio=regret.slope_ratio(cum),
            queries_per_s=HORIZON / wall, ms_per_tick=1e3 * wall / n_ticks,
            ticks=n_ticks, launches=counts,
            final_energy_mean=float(energy[-1].mean()))
    runs["profile"] = profile_ticks(
        lambda n: env.run(TorchDraws(seed, dev), short_env(envd, n), pol,
                          batch=BATCH, pool_schedule=sched,
                          aux_fn=energy_aux(cfg)),
        runs["sync"]["ms_per_tick"], 2 * cfg.sgld_steps)
    return runs


def short_env(envd, ticks):
    from repro_torch.core import env
    return env.EnvData(envd.x[:ticks * BATCH], envd.utils[:ticks * BATCH])


def profile_ticks(run, ms_per_tick, sgld_steps=None, ticks=2):
    """Device busy time and kernel launches per tick from ``torch.profiler``
    (device activity only) over ``run(ticks)``, a few ticks of a path's
    loop (or a few batches of the encoder). The idle share is taken against
    the path's unprofiled ms per tick, since the profiler slows the
    host."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(ticks)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kern = sorted(_kernel_events(prof), key=lambda e: -e[1])
    busy_ms = sum(us for _, us, _ in kern) / 1e3 / ticks
    launches = sum(n for _, _, n in kern) / ticks
    return dict(ticks=ticks, profiled_ms_per_tick=wall_ms / ticks,
                unprofiled_ms_per_tick=ms_per_tick,
                device_busy_ms_per_tick=busy_ms,
                device_idle_share=1.0 - busy_ms / ms_per_tick,
                device_kernels_per_tick=launches,
                device_kernels_per_sgld_step=(launches / sgld_steps
                                              if sgld_steps else None),
                top_kernels_ms_per_tick=[[k[:60], us / 1e3 / ticks, n / ticks]
                                         for k, us, n in kern[:6]])


def autopilot_setup(seed, dev, t_total, every):
    from repro_torch import autopilot
    envd, pool, cfg, pol = slice_setup(seed, dev, t_total, dominated=True)
    ap_cfg = autopilot.AutopilotConfig(**dict(AP_KW, every=every))
    return envd, pool, cfg, autopilot.wrap(pol, ap_cfg)


def phase_autopilot(dev, seed):
    """The autopilot over the pooled FGTS policy at full width: arm BAD
    dominated and overpriced, slot ARRIVAL joining at ARRIVAL_TICK."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import env, model_pool as mp, regret
    from repro_torch.core.draws import TorchDraws
    envd, pool, cfg, pol = autopilot_setup(seed, dev, HORIZON,
                                           AP_KW["every"])
    n_ticks = HORIZON // BATCH
    sched = mp.schedule([(ARRIVAL_TICK, ARRIVAL, pool.a_emb[ARRIVAL],
                          float(pool.costs[ARRIVAL]))], DIM, device=dev)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cum, state, (a1, a2, active) = env.run(
        TorchDraws(seed, dev), envd, pol, batch=BATCH, pool_schedule=sched,
        aux_fn=lambda s, a1, a2: (a1, a2, mp.get_pool(s).active))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    for k in ("dueling_score", "dueling_select", "sgld_potential_grad"):
        check(counts[k] > 0, f"autopilot: {k} never launched: {counts}")
    rows = torch.arange(n_ticks, device=dev)[:, None]
    check(bool(active[rows, a1.long()].all() and
               active[rows, a2.long()].all()),
          "autopilot: an arm was routed while inactive")
    check(bool(torch.isfinite(cum).all()) and cum.shape == (HORIZON,),
          "autopilot: regret curve not finite / wrong shape")
    off = (~active[:, BAD]).nonzero()
    ctrl, final = state.ctrl, mp.get_pool(state)
    ms_per_tick = 1e3 * wall / n_ticks
    prof = profile_ticks(
        lambda t: env.run(TorchDraws(seed, dev), short_env(envd, t), pol,
                          batch=BATCH, pool_schedule=sched),
        ms_per_tick, 2 * cfg.sgld_steps)
    if bool(ctrl.candidate[ARRIVAL]):
        fate = "candidate"
    elif bool(final.active[ARRIVAL]):
        fate = "promoted"
    else:
        fate = "rolled back"
    return dict(
        final_regret=float(cum[-1]), slope_ratio=regret.slope_ratio(cum),
        queries_per_s=HORIZON / wall, ms_per_tick=ms_per_tick,
        ticks=n_ticks, launches=counts, profile=prof,
        bad_arm_retired_at_tick=int(off[0, 0]) if off.numel() else None,
        final_lambda=float(ctrl.lam), final_cost_ema=float(ctrl.cost_ema),
        arrival_registered=bool(ctrl.known[ARRIVAL]), arrival_fate=fate,
        arrival_wins=float(ctrl.cand_wins[ARRIVAL]),
        arrival_duels=float(ctrl.cand_duels[ARRIVAL]),
        final_active=int(final.active.sum()))


def phase_mixed(dev, seed):
    """The mixed duel + click estimator at full width: act -> BTL feedback
    -> update -> a click on half of the batch's rows (a like when the
    answering arm beats the row's median utility) -> the energy trace."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import extensions, regret
    envd, pool, cfg, _ = slice_setup(seed, dev, HORIZON)
    pol = extensions.mixed_feedback_policy(pool, cfg)
    n_ticks, half = HORIZON // BATCH, BATCH // 2
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, energy, regrets = mixed_ticks(pol, envd, cfg, seed, dev, n_ticks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    for k in ("sgld_mixed_fwd", "sgld_mixed_grad", "dueling_select"):
        check(counts[k] > 0, f"mixed: {k} never launched: {counts}")
    h, theta = state.inner
    energy = torch.stack(energy)
    cum = torch.cumsum(torch.stack(regrets).reshape(-1), dim=0)
    check(bool(torch.isfinite(theta).all()) and bool(
        torch.isfinite(energy).all()), "mixed: chains or energy not finite")
    check(int(h.t) == n_ticks * (BATCH + half), "mixed: ring count wrong")
    ms_per_tick = 1e3 * wall / n_ticks
    prof = profile_ticks(
        lambda t: mixed_ticks(pol, envd, cfg, seed, dev, t), ms_per_tick,
        cfg.sgld_steps)
    return dict(ms_per_tick=ms_per_tick, queries_per_s=HORIZON / wall,
                ticks=n_ticks, launches=counts, profile=prof,
                final_regret=float(cum[-1]),
                slope_ratio=regret.slope_ratio(cum),
                click_rows_in_ring=int((~h.is_duel).sum()),
                final_energy_mean=float(energy[-1].mean()))


def mixed_ticks(pol, envd, cfg, seed, dev, n_ticks):
    """``n_ticks`` ticks of the mixed path from a fresh state: (state,
    per-tick energies, per-tick regrets)."""
    import torch
    from repro_torch.core import btl, extensions, regret
    from repro_torch.core.draws import TorchDraws
    draws = TorchDraws(seed, dev)
    half = BATCH // 2
    rows = torch.arange(BATCH, device=dev)
    state = pol.init(draws)
    energy, regrets = [], []
    for s in range(n_ticks):
        k_act, k_fb = draws.split(2)
        xb = envd.x[s * BATCH:(s + 1) * BATCH]
        ub = envd.utils[s * BATCH:(s + 1) * BATCH]
        state, a1, a2 = pol.act(k_act, state, xb)
        y = btl.sample_preference(k_fb, envd.feedback_scale * ub[rows, a1.long()],
                                  envd.feedback_scale * ub[rows, a2.long()])
        state = pol.update(state, xb, a1, a2, y)
        like = ub[rows[:half], a1[:half].long()] \
            > ub[:half].median(dim=-1).values
        state = extensions.inject_clicks(state, xb[:half], a1[:half],
                                         like.float())
        energy.append(extensions.mixed_chain_energy(state.inner,
                                                    state.pool.a_emb, cfg))
        regrets.append(regret.instant_regret(ub, a1, a2,
                                             active=state.pool.active))
    return state, energy, regrets


def ccft_setup(seed, dev, t_online):
    """The CCFT embedding path's inputs from one CPU generator seeded with
    ``seed``: ``EncoderConfig()`` with random weights, a RouterBench split
    (``CorpusConfig(seq_len=64)``, the encoder's max_len; 5 offline queries
    per benchmark; ``t_online`` online queries) and a MixInstruct dataset
    (``MixInstructConfig()``, 1200 queries). A card run and a CPU run get
    the same weights and tokens."""
    import torch
    from repro_torch.data import mixinstruct as mi, routerbench as rb, synth
    from repro_torch.encoder import EncoderConfig, init_encoder
    enc_cfg = EncoderConfig()
    corpus = synth.CorpusConfig(seq_len=enc_cfg.max_len)
    gen = torch.Generator().manual_seed(seed)
    params = init_encoder(gen, enc_cfg, device=dev)
    split = rb.make_split(gen, corpus, t_online=t_online, device=dev)
    data = mi.make_dataset(gen, corpus, mi.MixInstructConfig(), device=dev)
    return enc_cfg, params, split, data


def ccft_fgts_cfg(dim):
    """The paper-run FGTS settings (``benchmarks/common.py:79-86``) with the
    phase-2 chains, over the 11 RouterBench / MixInstruct LLMs."""
    from repro_torch.core import fgts
    return fgts.FGTSConfig(n_models=11, dim=dim, horizon=HORIZON, eta=8.0,
                           mu=0.2, sgld_steps=20, sgld_eps=5e-4,
                           sgld_minibatch=64, n_chains=8, force_distinct=True)


def routerbench_embeddings(enc_cfg, params, split):
    """The four weightings' model embeddings (metadata appended) and the
    RouterBench env (online queries, ones appended)."""
    from repro_torch.core import ccft
    from repro_torch.data import pipeline
    embs = {w: pipeline.routerbench_model_embeddings(params, enc_cfg, split,
                                                     w)
            for w in ccft.WEIGHTINGS}
    return embs, pipeline.routerbench_env(params, enc_cfg, split)


def phase_ccft(dev, seed):
    """The CCFT embedding path at ``EncoderConfig()`` width: query tokens
    -> encoder (attention on the flash kernel) -> model and query
    embeddings -> ``env.run`` over FGTS.CDB, for RouterBench (routing over
    the excel_perf_cost embeddings, d = 256 + 14) and for MixInstruct
    (eq. 6 embeddings, d = 256). Each is one run with the launch counts
    reset just before it and read just after."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import env, policy, regret
    from repro_torch.core.draws import TorchDraws
    from repro_torch.data import pipeline
    enc_cfg, params, split, data = ccft_setup(seed, dev, HORIZON)
    eb = pipeline.ENCODE_BATCH
    n_batches = HORIZON // eb

    def encode_online(n):
        return pipeline._batched_encode(params, split.online_tokens[:n * eb],
                                        split.online_mask[:n * eb], enc_cfg)
    encode_online(1)                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_alone = encode_online(n_batches)
    torch.cuda.synchronize()
    enc_ms = 1e3 * (time.perf_counter() - t0) / n_batches
    enc_prof = profile_ticks(encode_online, enc_ms)

    out = {}
    for name in ("routerbench", "mixinstruct"):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "routerbench":
            embs, envd = routerbench_embeddings(enc_cfg, params, split)
            a = embs["excel_perf_cost"]
            n_encoded = [split.offline_tokens.shape[0]] * len(embs) + [
                split.online_tokens.shape[0]]
            n_meta = 2 * len(split.benchmarks)
        else:
            envd, a = pipeline.mixinstruct_env_and_embeddings(
                params, enc_cfg, data)
            embs = {"label_proportion": a}
            n_encoded, n_meta = [data["tokens"].shape[0]], 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cfg = ccft_fgts_cfg(a.shape[1])
        pol = policy.fgts_policy(a, cfg)
        cum, _ = env.run(TorchDraws(seed, dev), envd, pol, batch=BATCH)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = kernels.launch_counts()
        batches = sum(-(-q // eb) for q in n_encoded)
        check(counts["flash_attention"] == enc_cfg.n_layers * batches,
              f"ccft {name}: {counts['flash_attention']} attention launches "
              f"for {batches} encode batches of {enc_cfg.n_layers} layers")
        for k in ("dueling_select", "sgld_potential_grad"):
            check(counts[k] > 0, f"ccft {name}: {k} never launched: {counts}")
        d = enc_cfg.d_model + n_meta
        for w, e in embs.items():
            check(e.shape == (11, d) and bool(torch.isfinite(e).all()),
                  f"ccft {name}: {w} embeddings {tuple(e.shape)} / not finite")
        x = envd.x
        norms = torch.linalg.vector_norm(x[:, :enc_cfg.d_model], dim=-1)
        check(bool(torch.isfinite(x).all()) and x.shape[1] == d and bool(
            ((norms - 1.0).abs() < 1e-4).all()),
            f"ccft {name}: query embeddings not unit-norm / wrong shape")
        if n_meta:
            check(bool((x[:, enc_cfg.d_model:] == 1.0).all()),
                  f"ccft {name}: metadata slots of x are not ones")
            check(float((x[:, :enc_cfg.d_model] - x_alone).abs().max())
                  <= 1e-6, f"ccft {name}: encode is not repeatable")
        n_ticks = x.shape[0] // BATCH
        check(bool(torch.isfinite(cum).all())
              and cum.shape == (n_ticks * BATCH,),
              f"ccft {name}: regret curve not finite / wrong shape")
        ms_per_tick = 1e3 * (t2 - t1) / n_ticks
        out[name] = dict(
            queries_encoded=sum(n_encoded), encode_batches=batches,
            pipeline_s=t1 - t0, ticks=n_ticks, ms_per_tick=ms_per_tick,
            queries_per_s=n_ticks * BATCH / (t2 - t1), dim=d,
            final_regret=float(cum[-1]), slope_ratio=regret.slope_ratio(cum),
            launches=counts,
            flash_launches_per_encode_batch=counts["flash_attention"]
            / batches)
        if name == "routerbench":
            out[name]["profile"] = profile_ticks(
                lambda t: env.run(TorchDraws(seed, dev), short_env(envd, t),
                                  pol, batch=BATCH),
                ms_per_tick, 2 * cfg.sgld_steps)
    out["encode"] = dict(batch=eb, ms_per_batch=enc_ms,
                         queries_per_s=1e3 * eb / enc_ms, profile=enc_prof)
    return out


def phase_ccft_card_vs_cpu(dev, seed):
    """The CCFT path on the card and on the CPU from the same weights and
    tokens: every embedding (the four weightings' model embeddings, the
    RouterBench queries, the MixInstruct queries and eq. 6 embeddings) to
    atol 1e-5; then 4 RouterBench ticks of ``env.run`` from one HostDraws
    set: pairs equal outside near-ties, final chains to rtol 1e-4."""
    import torch
    from repro_torch.core import env, policy
    from repro_torch.core.draws import HostDraws
    from repro_torch.data import pipeline
    ticks = 4

    def run(where):
        enc_cfg, params, split, data = ccft_setup(seed, where, BATCH * ticks)
        embs, envd = routerbench_embeddings(enc_cfg, params, split)
        menv, m_a = pipeline.mixinstruct_env_and_embeddings(params, enc_cfg,
                                                            data)
        pol = policy.fgts_policy(embs["excel_perf_cost"],
                                 ccft_fgts_cfg(envd.x.shape[1]))

        def aux(state, a1, a2):
            return (a1, a2, state.theta1.mean(0), state.theta2.mean(0))
        _, state, trace = env.run(HostDraws(seed), envd, pol, batch=BATCH,
                                  aux_fn=aux)
        named = dict({f"a_{w}": e for w, e in embs.items()},
                     routerbench_x=envd.x, mixinstruct_x=menv.x,
                     mixinstruct_a=m_a)
        return named, envd, state, trace
    g_emb, _, g_state, g_trace = run(dev)
    c_emb, envd, c_state, (c1, c2, th1, th2) = run(torch.device("cpu"))
    errs = {}
    for k, c in c_emb.items():
        errs[k] = float((g_emb[k].cpu() - c).abs().max())
        check(errs[k] <= 1e-5, f"ccft card vs cpu: {k} differs by {errs[k]}")
    a = c_emb["a_excel_perf_cost"]
    bad = ties = 0
    for s in range(ticks):
        x = envd.x[s * BATCH:(s + 1) * BATCH]
        b, t_, _ = compare_pairs(
            x, a, torch.stack([th1[s], th2[s]]), None, None, True,
            (g_trace[0][s].cpu(), g_trace[1][s].cpu()), (c1[s], c2[s]))
        bad, ties = bad + b, ties + t_
    check(bad == 0, f"ccft card vs cpu: {bad} pair mismatches outside "
                    f"near-ties")
    for f in ("theta1", "theta2"):
        gc, cc = getattr(g_state, f).cpu(), getattr(c_state, f)
        err = (gc - cc).abs()
        errs[f] = float(err.max())
        check(bool((err <= 1e-5 + 1e-4 * cc.abs()).all()),
              f"ccft card vs cpu: {f} differs by {errs[f]}")
    return dict(ticks=ticks, pair_mismatches=bad, near_ties=ties,
                max_abs_err=errs)


def gate_logged_draws(seed, log):
    """A ``HostDraws`` that also appends each (BATCH,) uniform it hands out
    to ``log``. The first of a tick is the autopilot's quota gate (the
    first draw of its act); the BTL uniforms follow."""
    from repro_torch.core.draws import HostDraws

    class Logged(HostDraws):
        def uniform(self, shape, device):
            v = super().uniform(shape, device)
            if tuple(shape) == (BATCH,):
                log.append(v.cpu())
            return v
    return Logged(seed)


CTRL_TRACE = ("candidate", "cand_wins", "cand_duels", "dominated_ticks")


def phase_autopilot_card_vs_cpu(dev, seed):
    """4 autopilot ticks (a control tick every 2 acts) on the card and on
    the CPU from one HostDraws set. Slot ARRIVAL joins at tick 1, so from
    the second act on a candidate is live: the quota gate masks it out of
    ungated rows, its resolved duels fold into the candidate counters, and
    the control tick at act 4 may promote or roll it back. Pairs are held
    against the plain scores under each row's own mask (from the logged
    gate); the controller's fields after every tick are held exactly."""
    import torch
    from repro_torch.core import env, model_pool as mp
    ticks, arrival_tick = 4, 1

    def run(where):
        envd, pool, _, pol = autopilot_setup(seed, where, BATCH * ticks, 2)
        sched = mp.schedule([(arrival_tick, ARRIVAL, pool.a_emb[ARRIVAL],
                              float(pool.costs[ARRIVAL]))], DIM, device=where)
        log, gates = [], []

        def aux(state, a1, a2):
            gates.append(log[0])
            log.clear()
            inner, ctrl = state.inner.inner, state.ctrl
            return (a1, a2, inner.theta1.mean(0), inner.theta2.mean(0),
                    mp.get_pool(state).active, ctrl.lam,
                    *(getattr(ctrl, f) for f in CTRL_TRACE))
        _, state, trace = env.run(gate_logged_draws(seed, log), envd, pol,
                                  batch=BATCH, pool_schedule=sched,
                                  aux_fn=aux)
        return envd, pool, state, trace, torch.stack(gates)
    _, _, card_state, g_trace, g_gate = run(dev)
    envd, pool, cpu_state, c_trace, gate = run(torch.device("cpu"))
    (g1, g2), (c1, c2, th1, th2, act, lam) = g_trace[:2], c_trace[:6]
    cand = c_trace[6]
    check(torch.equal(g_gate, gate), "autopilot card vs cpu: gate draws differ")
    check(bool(cand[arrival_tick:, ARRIVAL].any()) and not bool(
        cand[:arrival_tick].any()),
        "autopilot card vs cpu: the arrival never became a candidate")
    quota = AP_KW["quota"]
    rows = torch.arange(BATCH)
    bad = ties = cand_rows = 0
    for s in range(ticks):
        x = envd.x[s * BATCH:(s + 1) * BATCH]
        has_full = bool((act[s] & ~cand[s]).any())
        mask = ((gate[s] < quota)[:, None] | ~cand[s][None, :]
                | (not has_full)) & act[s][None, :]
        check(bool(mask[rows, c1[s].long()].all()
                   and mask[rows, c2[s].long()].all()),
              f"autopilot: tick {s} routed an arm outside its row's mask")
        b, t_, _ = compare_pairs(
            x, pool.a_emb, torch.stack([th1[s], th2[s]]), lam[s] * pool.costs,
            mask, True, (g1[s].cpu(), g2[s].cpu()), (c1[s], c2[s]))
        bad, ties = bad + b, ties + t_
        cand_rows += int((cand[s][c1[s].long()]
                          | cand[s][c2[s].long()]).sum())
    check(bad == 0, f"autopilot card vs cpu: {bad} pair mismatches outside "
                    f"near-ties")
    check(cand_rows > 0, "autopilot card vs cpu: the candidate never duelled")
    for f, g, c in zip(CTRL_TRACE, g_trace[6:], c_trace[6:]):
        check(torch.equal(g.cpu(), c),
              f"autopilot card vs cpu: ctrl.{f} differs in some tick")
    gc, cc = card_state.ctrl, cpu_state.ctrl
    for f in ("known", "tick"):
        check(torch.equal(getattr(gc, f).cpu(), getattr(cc, f)),
              f"autopilot card vs cpu: ctrl.{f} differs")
    check(torch.equal(mp.get_pool(card_state).active.cpu(),
                      mp.get_pool(cpu_state).active),
          "autopilot card vs cpu: pool membership differs")
    errs = {}
    for f in ("lam", "cost_ema"):
        g, c = float(getattr(gc, f)), float(getattr(cc, f))
        errs[f] = abs(g - c)
        check(errs[f] <= 1e-5 * abs(c) + 1e-7,
              f"autopilot card vs cpu: {f} {g} vs {c}")
    final = mp.get_pool(cpu_state)
    if bool(cc.candidate[ARRIVAL]):
        fate = "candidate"
    elif bool(final.active[ARRIVAL]):
        fate = "promoted"
    else:
        fate = "rolled back"
    return dict(ticks=ticks, pair_mismatches=bad, near_ties=ties,
                ctrl_abs_err=errs, final_lambda=float(cc.lam),
                dominated_ticks=cc.dominated_ticks.tolist(),
                rows_gated=int((gate < quota).sum()),
                rows_with_candidate=cand_rows, arrival_fate=fate,
                arrival_wins_per_tick=c_trace[7][:, ARRIVAL].tolist(),
                arrival_duels_per_tick=c_trace[8][:, ARRIVAL].tolist(),
                final_active=int(final.active.sum()))


def phase_card_vs_cpu(dev, seed):
    import torch
    from repro_torch.core import env
    from repro_torch.core.draws import HostDraws
    ticks = 4
    out = {}
    for where in (dev, torch.device("cpu")):
        envd, pool, cfg, pol = slice_setup(seed, where, BATCH * ticks)

        def aux(state, a1, a2):
            return (a1, a2, state.inner.theta1.mean(0),
                    state.inner.theta2.mean(0))
        _, state, trace = env.run(HostDraws(seed), envd, pol, batch=BATCH,
                                  aux_fn=aux)
        out[where.type] = (envd, pool, state, trace)
    envd, pool, cpu_state, (c1, c2, th1, th2) = out["cpu"]
    _, _, card_state, (g1, g2, _, _) = out["cuda"]
    bad = ties = 0
    for s in range(ticks):
        x = envd.x[s * BATCH:(s + 1) * BATCH]
        b, t_, e = compare_pairs(
            x, pool.a_emb, torch.stack([th1[s], th2[s]]), None, pool.active,
            True, (g1[s].cpu(), g2[s].cpu()), (c1[s], c2[s]))
        bad, ties = bad + b, ties + t_
    check(bad == 0, f"card vs cpu: {bad} pair mismatches outside near-ties")
    errs = {}
    for f in ("theta1", "theta2"):
        gc = getattr(card_state.inner, f).cpu()
        cc = getattr(cpu_state.inner, f)
        err = (gc - cc).abs()
        errs[f] = float(err.max())
        check(bool((err <= 1e-5 + 1e-4 * cc.abs()).all()),
              f"card vs cpu: {f} differs by {errs[f]}")
    return dict(ticks=ticks, pair_mismatches=bad, near_ties=ties,
                theta_max_abs_err=errs)


# ---------------------------------------------------------------------------
# phases 2 and 3: the candidate LMs' generation path
# ---------------------------------------------------------------------------

LM_B, LM_S, LM_STEPS = 2, 4096, 8
# the kernels of each model's prefill, with their launches per prefill
LM_PATHS = {
    "mamba2-1.3b": {"ssd_scan": 48},
    "recurrentgemma-9b": {"rglru_scan": 26, "flash_attention": 12},
}
# each kernel's name in a profile
KERNEL_SYMBOLS = {"ssd_scan": "ssd_kernel", "rglru_scan": "rglru_kernel",
                  "flash_attention": "flash_attention_kernel"}


def tree_leaves(tree):
    out = []
    from repro_torch.models.layers import tree_map
    tree_map(out.append, tree)
    return out


def profile_prefill(run, prefill_ms, wrappers):
    """One prefill under ``torch.profiler`` (device activity only): device
    busy time, idle share against the unprofiled prefill, kernels per
    prefill, and the share of busy time of each port kernel, of the GEMMs
    (cuBLAS / CUTLASS kernels) and of the heaviest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kern = sorted(_kernel_events(prof), key=lambda e: -e[1])
    busy = sum(us for _, us, _ in kern) / 1e3
    share = lambda pred: (sum(us for k, us, _ in kern if pred(k)) / 1e3
                          / busy if busy else None)
    gemm = lambda k: any(w in k.lower()
                         for w in ("gemm", "cutlass", "xmma", "nvjet"))
    return dict(
        device_busy_ms=busy, device_idle_share=1.0 - busy / prefill_ms,
        device_kernels_per_prefill=sum(n for _, _, n in kern),
        kernel_share={w: share(lambda k, w=w: KERNEL_SYMBOLS[w] in k)
                      for w in wrappers},
        gemm_share=share(gemm),
        top_kernels=[[k[:70], us / 1e3, n] for k, us, n in kern[:8]])


def greedy_steps(params, cache, logits, cfg, n):
    """``n`` more greedy decode steps after ``logits`` (positions past the
    timed run's; they write into ``cache``, which is not used after)."""
    from repro_torch.models import lm
    for i in range(n):
        logits, cache = lm.decode_step(params, cache, logits.argmax(-1),
                                       LM_S + LM_STEPS + i, cfg)


def phase_lm(dev, seed):
    """mamba2-1.3b and recurrentgemma-9b at their full configs (random bf16
    weights from a generator on the card): B 2 prompts of S 4096 random
    tokens, ``lm.prefill`` (cache_len S + 8), then 8 greedy
    ``lm.decode_step``s, as ``examples/routed_serving_e2e.py::
    greedy_decode`` does. One warm-up run first; then the launch counts
    are reset, the path runs timed, and the counts are read after the
    prefill and after the decode: each kernel of the model's prefill
    exactly ``LM_PATHS`` times, nothing from decode. One more prefill and
    two more decode steps run under the profiler (device activity only)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.models import lm
    out = {}
    for name, per_prefill in LM_PATHS.items():
        cfg = ARCHS[name]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        t0 = time.perf_counter()
        params = lm.init_params(gen, cfg, device=dev)
        tok = torch.randint(0, cfg.vocab_size, (LM_B, LM_S), generator=gen,
                            device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        leaves = tree_leaves(params)
        cache_len = LM_S + LM_STEPS
        batch = {"tokens": tok}
        last, cache = lm.prefill(params, batch, cfg, cache_len)  # warm-up
        lm.decode_step(params, cache, last.argmax(-1), LM_S, cfg)
        del last, cache
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)

        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        last, cache = lm.prefill(params, batch, cfg, cache_len)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        per = kernels.launch_counts()
        logits, generated = [last], []
        nxt = last.argmax(-1)
        for i in range(LM_STEPS):
            generated.append(nxt)
            lg, cache = lm.decode_step(params, cache, nxt, LM_S + i, cfg)
            logits.append(lg)
            nxt = lg.argmax(-1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)

        for k, n in per.items():
            want = per_prefill.get(k, 0)
            check(n == want, f"lm {name}: {n} {k} launches per prefill, "
                             f"want {want}")
        check(counts == per, f"lm {name}: decode launched a kernel: "
                             f"{counts} after the prefill's {per}")
        lg = torch.stack(logits)
        check(lg.shape == (LM_STEPS + 1, LM_B, cfg.vocab_size)
              and bool(torch.isfinite(lg).all()),
              f"lm {name}: logits {tuple(lg.shape)} / not finite")
        toks = torch.stack(generated, dim=1)
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"lm {name}: generated tokens out of range")
        prefill_ms = 1e3 * (t1 - t0)
        out[name] = dict(
            params=sum(t.numel() for t in leaves),
            weights_gb=sum(t.numel() * t.element_size() for t in leaves)
            / 1e9, init_s=init_s, batch=LM_B, prompt_len=LM_S,
            decode_steps=LM_STEPS, prefill_ms=prefill_ms,
            prompt_tokens_per_s=LM_B * LM_S / (t1 - t0),
            decode_ms_per_token=1e3 * (t2 - t1) / LM_STEPS,
            peak_memory_gb=peak / 1e9, launches_per_prefill=per,
            launches=counts, generated=toks.tolist(),
            profile=profile_prefill(
                lambda: lm.prefill(params, batch, cfg, cache_len),
                prefill_ms, per_prefill),
            decode_profile=profile_ticks(
                lambda n: greedy_steps(params, cache, logits[-1], cfg, n),
                1e3 * (t2 - t1) / LM_STEPS))
        del params, leaves, cache, logits, lg, last
        torch.cuda.empty_cache()
    return out


# full width in fp32 at a smaller depth, for the card against the CPU
LM_CPU_CUTS = {"mamba2-1.3b": dict(n_units=2),
               "recurrentgemma-9b": dict(n_units=1, remainder=())}


def phase_lm_card_vs_cpu(dev, seed):
    """Each model at full width in fp32 (``LM_CPU_CUTS`` depth), weights
    made once on the card from the seed and copied to the CPU; B 2 prompts
    of S 500 (a ragged SSD tail), prefill and 4 decode steps on the card
    and on the CPU, both fed the CPU's greedy tokens. Every step's logits
    within 1e-4 of the largest |logit|, the card's greedy token equal to
    the CPU's outside near-ties, every cache leaf within 1e-4 of its
    largest magnitude, ``slot_pos`` equal."""
    import dataclasses
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import lm
    from repro_torch.models.layers import tree_map
    b, s, steps = 2, 500, 4
    cpu = torch.device("cpu")
    out = {}
    for name, cut in LM_CPU_CUTS.items():
        cfg = dataclasses.replace(ARCHS[name], dtype="float32", **cut)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = lm.init_params(gen, cfg, device=dev)
        tok = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                            device=dev)
        cparams = tree_map(lambda t: t.to(cpu), params)
        g_last, g_cache = lm.prefill(params, {"tokens": tok}, cfg, s + steps)
        c_last, c_cache = lm.prefill(cparams, {"tokens": tok.to(cpu)}, cfg,
                                     s + steps)
        pairs = [(g_last.to(cpu), c_last)]
        nxt = c_last.argmax(-1)
        for i in range(steps):
            g_lg, g_cache = lm.decode_step(params, g_cache, nxt.to(dev),
                                           s + i, cfg)
            c_lg, c_cache = lm.decode_step(cparams, c_cache, nxt, s + i, cfg)
            pairs.append((g_lg.to(cpu), c_lg))
            nxt = c_lg.argmax(-1)
        logit_err = bad = ties = 0
        for g, c in pairs:
            err = float((g - c).abs().max())
            logit_err = max(logit_err, err / float(c.abs().max()))
            check(err <= 1e-4 * float(c.abs().max()),
                  f"lm card vs cpu {name}: logits differ by {err}")
            miss = g.argmax(-1) != c.argmax(-1)
            tie = top2_gap(c) <= NEAR_TIE * float(c.abs().max())
            bad, ties = bad + int((miss & ~tie).sum()), ties + int(
                (miss & tie).sum())
        check(bad == 0, f"lm card vs cpu {name}: {bad} greedy tokens differ "
                        f"outside near-ties")
        cache_err = 0.0
        for g, c in zip(tree_leaves(g_cache), tree_leaves(c_cache)):
            g = g.to(cpu)
            if c.dtype == torch.int32:
                check(torch.equal(g, c), f"lm card vs cpu {name}: slot_pos "
                                         f"differs")
                continue
            err = float((g - c).abs().max())
            scale = max(float(c.abs().max()), 1e-30)
            cache_err = max(cache_err, err / scale)
            check(err <= 1e-4 * scale,
                  f"lm card vs cpu {name}: a cache leaf differs by {err}")
        out[name] = dict(n_layers=cfg.n_layers, batch=b, prompt_len=s,
                         decode_steps=steps, max_rel_logit_err=logit_err,
                         max_rel_cache_err=cache_err, token_mismatches=bad,
                         near_ties=ties)
        del params, cparams, g_cache, c_cache
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------

SGLD_SRC = "src/repro_torch/kernels/csrc/sgld_potential.cu"
# name, source, TPU kernel replaced (its pl.pallas_call), phase-1 cases,
# field prefix in the cases, the path run whose launches count
KERNELS = [
    ("dueling_select", "src/repro_torch/kernels/csrc/dueling_select.cu",
     "src/repro/kernels/dueling_score.py:234", "select", "", "sync"),
    ("sgld_potential_fwd", SGLD_SRC, "src/repro/kernels/sgld_update.py:255",
     "sgld", "fwd_", "sync"),
    ("sgld_potential_grad", SGLD_SRC, "src/repro/kernels/sgld_update.py:272",
     "sgld", "grad_", "sync"),
    ("dueling_score", "src/repro_torch/kernels/csrc/dueling_score.cu",
     "src/repro/kernels/dueling_score.py:108", "score", "", "autopilot"),
    ("sgld_mixed_fwd", SGLD_SRC, "src/repro/kernels/sgld_update.py:255",
     "mixed", "fwd_", "mixed"),
    ("sgld_mixed_grad", SGLD_SRC, "src/repro/kernels/sgld_update.py:272",
     "mixed", "grad_", "mixed"),
    ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:99", "attn", "", "ccft"),
    ("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
     "src/repro/kernels/ssd_scan.py:109", "ssd", "", "mamba2-1.3b"),
    ("rglru_scan", "src/repro_torch/kernels/csrc/rglru_scan.cu",
     "src/repro/kernels/rglru_scan.py:72", "rglru", "", "recurrentgemma-9b"),
]


# the bf16 cases of flash_attention timed beside its fp32 main and bench,
# and the fp32 case of ssd_scan (the SIMT kernel) beside its bf16 ones
ATTN_BF16_TIMED = ("qwen2_bf16", "recurrentgemma_bf16")
SSD_FP32_TIMED = ("main_fp32",)


def kernels_line(cases, launches):
    """``cases``: phase-1 case lists by family; ``launches``: the launch
    counts of each path run by its name. ``library_ms`` is the time of
    ``scaled_dot_product_attention`` for ``flash_attention`` (same inputs)
    and null for the others: no one PyTorch call computes them. The
    ``flash_attention`` row also carries its timed bf16 cases (the Hopper
    kernel) under ``bf16``, the ``ssd_scan`` row its timed fp32 case (the
    SIMT kernel) under ``fp32``. The two forward kernels are reached on their
    paths only through the energy trace the runs here add
    (``fgts.chain_energy`` on the slice runs,
    ``extensions.mixed_chain_energy`` on the mixed run): the policies' own
    act and update launch the gradient kernels alone."""
    rows = []
    for name, src, replaces, fam, pre, run in KERNELS:
        fam_cases = cases[fam]
        m = next(r for r in fam_cases if r["case"] == "main")
        bch = next(r for r in fam_cases if r["case"] == "bench")
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[run][name],
            max_abs_err=max(r[pre + "max_abs_err"] for r in fam_cases),
            ms=m[pre + "ms"], plain_ms=m[pre + "plain_ms"],
            bound_ms=m[pre + "bound_ms"], bound_by=m[pre + "bound_by"],
            library_ms=m.get(pre + "library_ms"),
            device_ms=m[pre + "device_ms"],
            plain_device_ms=m[pre + "plain_device_ms"],
            bench_ms=bch[pre + "ms"], bench_plain_ms=bch[pre + "plain_ms"],
            bench_device_ms=bch[pre + "device_ms"],
            bench_plain_device_ms=bch[pre + "plain_device_ms"],
            bench_bound_ms=bch[pre + "bound_ms"],
            bench_bound_by=bch[pre + "bound_by"]))
        extra = dict(flash_attention=("bf16", ATTN_BF16_TIMED),
                     ssd_scan=("fp32", SSD_FP32_TIMED)).get(name)
        if extra:
            rows[-1][extra[0]] = {
                r["case"]: {k: r.get(k) for k in (
                    "ms", "device_ms", "bound_ms", "bound_by", "library_ms",
                    "library_device_ms", "plain_ms", "plain_device_ms")}
                for r in fam_cases if r["case"] in extra[1]}
    return {"kernels": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every phase's full record here (JSON)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this script runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    record = {}

    t0 = time.perf_counter()
    _build.build_all()
    record["build"] = dict(phase="build", seconds=time.perf_counter() - t0,
                           libraries=sorted(_build.SIGNATURES))
    emit(record["build"])

    sel, sg, sc, mx, at, ssd, rgl = phase_kernels(dev, args.seed)
    record["kernels"] = dict(phase="kernels", dueling_select=sel,
                             sgld_potential=sg, dueling_score=sc,
                             sgld_mixed=mx, flash_attention=at, ssd_scan=ssd,
                             rglru_scan=rgl)
    emit(record["kernels"])

    runs = phase_slice(dev, args.seed)
    record["slice"] = dict(phase="slice", **runs)
    emit(record["slice"])
    record["autopilot"] = dict(phase="autopilot",
                               **phase_autopilot(dev, args.seed))
    emit(record["autopilot"])
    record["mixed"] = dict(phase="mixed", **phase_mixed(dev, args.seed))
    emit(record["mixed"])
    record["ccft"] = dict(phase="ccft", **phase_ccft(dev, args.seed))
    emit(record["ccft"])
    record["lm"] = dict(phase="lm", **phase_lm(dev, args.seed))
    emit(record["lm"])

    record["card_vs_cpu"] = dict(
        phase="card_vs_cpu", **phase_card_vs_cpu(dev, args.seed),
        autopilot=phase_autopilot_card_vs_cpu(dev, args.seed),
        ccft=phase_ccft_card_vs_cpu(dev, args.seed),
        lm=phase_lm_card_vs_cpu(dev, args.seed))
    emit(record["card_vs_cpu"])

    line = kernels_line(
        dict(select=sel, sgld=sg, score=sc, mixed=mx, attn=at, ssd=ssd,
             rglru=rgl),
        dict(sync=runs["sync"]["launches"],
             autopilot=record["autopilot"]["launches"],
             mixed=record["mixed"]["launches"],
             ccft=record["ccft"]["routerbench"]["launches"],
             **{n: r["launches"] for n, r in record["lm"].items()
                if n != "phase"}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    record["card"] = smi
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(record, kernels_line=line["kernels"]), indent=1))
    emit(line)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
