#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--out FILE]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, in parallel) and runs three phases, printing one JSON
line per phase (phase 2 prints one per path):

1. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (K = 16 pool slots with 11 live RouterBench
   arms, d = 768, B = 256; SGLD m = 64 rows, C = 8 chains; the autopilot's
   posterior scores of 16 chains) and at the top row of the SGLD bench
   (K = 1024, m = 1024, C = 8; scores and selection B = 4096), plus edge
   cases. Pairs must agree outside near-ties (top-two gap below 1e-5 *
   max|s|, counted but not failures); scores to 1e-5 of max|s|, with
   duplicated arms bitwise equal and dominance matrices equal outside
   near-tied arm pairs; potentials to rtol 1e-5 and gradients to rtol 1e-4
   of the largest magnitude. Times are medians of CUDA-event-timed calls
   after a warm-up; the bound is the larger of the bytes over 3.35 TB/s and
   the fp32 operations over 67 TFLOP/s (H100 SXM data sheet).
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
     energy trace.
   Each run resets the launch counts just before it and reads them just
   after: every kernel of its path must have launched. Two more ticks of
   each path run under ``torch.profiler`` (device activity only) for the
   device busy time per tick, its idle share against the unprofiled run's
   ms per tick and the kernels per tick.
3. card vs CPU: 4 ticks at full width on the card and on the CPU (plain
   versions) from one numpy-made draw set, for the FGTS slice and for the
   autopilot (a control tick every 2 acts); routed pairs equal outside
   near-ties, final chains to rtol 1e-4, controller counters and flags
   equal, lambda and the cost EMA to rtol 1e-5.

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


def bound(nbytes, flops):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
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
    ]
    return sel, sg, sc, mx


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


def profile_ticks(run, ms_per_tick, sgld_steps, ticks=2):
    """Device busy time and kernel launches per tick from ``torch.profiler``
    (device activity only) over ``run(ticks)``, a few ticks of a path's
    loop. The idle share is taken against the path's unprofiled ms per
    tick, since the profiler slows the host."""
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
                device_kernels_per_sgld_step=launches / sgld_steps,
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
]


def kernels_line(cases, launches):
    """``cases``: phase-1 case lists by family; ``launches``: the launch
    counts of each path run by its name. ``library_ms`` is null for every
    kernel: no one PyTorch call computes any of these functions. The two
    forward kernels are reached on their paths only through the energy
    trace the runs here add (``fgts.chain_energy`` on the slice runs,
    ``extensions.mixed_chain_energy`` on the mixed run): the policies'
    own act and update launch the gradient kernels alone."""
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
            library_ms=None, device_ms=m[pre + "device_ms"],
            plain_device_ms=m[pre + "plain_device_ms"],
            bench_ms=bch[pre + "ms"], bench_plain_ms=bch[pre + "plain_ms"],
            bench_device_ms=bch[pre + "device_ms"],
            bench_plain_device_ms=bch[pre + "plain_device_ms"],
            bench_bound_ms=bch[pre + "bound_ms"],
            bench_bound_by=bch[pre + "bound_by"]))
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

    sel, sg, sc, mx = phase_kernels(dev, args.seed)
    record["kernels"] = dict(phase="kernels", dueling_select=sel,
                             sgld_potential=sg, dueling_score=sc,
                             sgld_mixed=mx)
    emit(record["kernels"])

    runs = phase_slice(dev, args.seed)
    record["slice"] = dict(phase="slice", **runs)
    emit(record["slice"])
    record["autopilot"] = dict(phase="autopilot",
                               **phase_autopilot(dev, args.seed))
    emit(record["autopilot"])
    record["mixed"] = dict(phase="mixed", **phase_mixed(dev, args.seed))
    emit(record["mixed"])

    record["card_vs_cpu"] = dict(
        phase="card_vs_cpu", **phase_card_vs_cpu(dev, args.seed),
        autopilot=phase_autopilot_card_vs_cpu(dev, args.seed))
    emit(record["card_vs_cpu"])

    line = kernels_line(
        dict(select=sel, sgld=sg, score=sc, mixed=mx),
        dict(sync=runs["sync"]["launches"],
             autopilot=record["autopilot"]["launches"],
             mixed=record["mixed"]["launches"]))
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
