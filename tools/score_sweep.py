#!/usr/bin/env python3
"""Both configurations of the ``dueling_score`` kernel forced at a sweep of
shapes, to place ``dueling_score.score_plan``'s bound.

    python3 tools/score_sweep.py [--out FILE]

For each (B, K, J) at d 768 it runs the score kernel once as Small (a warp
per output) and once as Large (64 x 64 tiles), whatever the plan would
pick, checks both against the plain version (1e-5 of max|s|) and prints
their device times (``chip_smoke.device_ms``), B*K*J*d and the plan's own
choice, with the card's name and power limit. Needs one CUDA card.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the records here (JSON)")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("score_sweep: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import dueling_score as ds
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
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
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
