#!/usr/bin/env python3
"""Both configurations of the ``dueling_score`` kernel, or with
``--select`` of the ``dueling_select`` kernel, forced at a sweep of shapes,
to place ``dueling_score.score_plan``'s or ``select_plan``'s bound.

    python3 tools/score_sweep.py [--select] [--out FILE]

For each (B, K, J) at d 768 it runs the score kernel once as Small (a warp
per output) and once as Large (64 x 64 tiles), whatever the plan would
pick, checks both against the plain version (1e-5 of max|s|) and prints
their device times (``chip_smoke.device_ms``), B*K*J*d and the plan's own
choice, with the card's name and power limit. With ``--select``, for each
(B, K) at d 768 it runs the select kernel as Small with each number of rows
per block it takes (1, and 8 for K <= 16; Small only for K <= 32) and as
Large, checks every routed pair against the plain
version (none may differ outside near-ties) and prints the device times
beside the plan's own choice. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
D = 768
SHAPES = [(1, 16, 16), (63, 16, 16), (128, 16, 16), (256, 16, 16),
          (63, 256, 2), (170, 1024, 1), (171, 1024, 1), (63, 1024, 2),
          (256, 64, 16), (63, 256, 16), (32, 1024, 16)]


SELECT_SHAPES = [(64, 16), (256, 16), (1024, 16), (4096, 16), (256, 11),
                 (256, 32), (1024, 32), (4096, 32), (256, 64), (4096, 64),
                 (256, 1024), (4096, 1024)]


def select_sweep(cs, dev, card) -> list:
    import torch
    from repro_torch.kernels import dueling_score as ds
    plan = ds.select_plan
    records = []
    for b, k in SELECT_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(b + k)
        x = torch.randn((b, D), generator=gen, device=dev)
        a = torch.randn((k, D), generator=gen, device=dev)
        th = torch.randn((2, D), generator=gen, device=dev)
        want = ds.dueling_select_plain(x, a, th, distinct=True)
        rec = dict(B=b, K=k, d=D, plan=list(plan(b, k, D)), card=card)
        large = plan(b, k, D, cfg=1)
        forced = [(f"small_r{r}", (0, r, 1, -(-b // r)))
                  for r in (1, 8) if k <= (32 if r == 1 else 16)]
        try:
            for label, p in forced + [("large", large)]:
                ds.select_plan = lambda *_, p=p: p
                got = ds.dueling_select(x, a, th, distinct=True)
                bad = cs.compare_pairs(x, a, th, None, None, True, got,
                                       want)[0]
                if bad:
                    raise SystemExit(f"score_sweep: {label} at B {b}, K {k}"
                                     f": {bad} pairs differ")
                rec[f"{label}_device_ms"] = cs.device_ms(
                    lambda: ds.dueling_select(x, a, th, distinct=True))
        finally:
            ds.select_plan = plan
        records.append(rec)
        print(json.dumps(rec), flush=True)
    return records


def score_sweep(cs, dev, card) -> list:
    import torch
    from repro_torch.kernels import dueling_score as ds
    plan = ds.score_plan
    tile, pair = ds.LARGE_TILE, ds.LARGE_J
    grids = {0: lambda b, k, j: (-(-(j * b * k) // ds.SMALL_WARPS), 1, 1),
             1: lambda b, k, j: (-(-k // tile), -(-b // tile), -(-j // pair))}
    records = []
    for b, k, j in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(b + k + j)
        x = torch.randn((b, D), generator=gen, device=dev)
        a = torch.randn((k, D), generator=gen, device=dev)
        th = torch.randn((j, D), generator=gen, device=dev)
        want = ds.dueling_score_plain(x, a, th)
        rec = dict(B=b, K=k, J=j, d=D, work=b * k * j * D,
                   plan=plan(b, k, j, D)[0], card=card)
        try:
            for cfg, label in ((0, "small"), (1, "large")):
                ds.score_plan = (lambda *_, cfg=cfg:
                                 (cfg, grids[cfg](b, k, j)))
                err = float((ds.dueling_score(x, a, th) - want).abs().max())
                if err > 1e-5 * float(want.abs().max()):
                    raise SystemExit(f"score_sweep: {label} off by {err}")
                rec[f"{label}_device_ms"] = cs.device_ms(
                    lambda: ds.dueling_score(x, a, th))
        finally:
            ds.score_plan = plan
        records.append(rec)
        print(json.dumps(rec), flush=True)
    return records


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--select", action="store_true",
                    help="sweep the select kernel's configurations")
    ap.add_argument("--out", help="also write the records here (JSON)")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("score_sweep: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    sweep = select_sweep if args.select else score_sweep
    records = sweep(cs, dev, card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
