#!/usr/bin/env python3
"""Host time of ``DrawPlan.fill`` against a flattened variant, on the card.

    python3 tools/fill_variants.py [--pairs 40] [--out FILE]

Builds ``chip_smoke.py``'s streaming service (the serve world on the
ladder (32, 64, 128, 256)) and takes the draw plan of its top bucket's
pref route: 80 raw draws, the act's whole plan. Then fills that plan's
buffers from fresh keys of the service, in pairs whose order alternates:

    walk   ``DrawPlan.fill`` as it stands: each entry's path walked from
           the root with ``KeyedDraws.split`` / ``fold_in``
    flat   the same keys derived on 64-bit words from the plan's steps
           flattened once (each key of the tree once), drawn with the
           same ``_fill``

Each fill is timed on the host clock with the card idle on both sides
(the fill's enqueue: hashing, re-seeding, the draw kernels' launches).
The two must fill bitwise the same buffers. Prints the card's name and
power limit, and one JSON line: entries, bitwise, each variant's median
and minimum ms, and the pairs each won. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def flat_fill(plan, root, bufs, steps=None):
    """``plan``'s entries drawn into ``bufs`` from ``root``'s key tree, the
    keys derived as ``KeyedDraws.split`` / ``fold_in`` derive them, on
    64-bit words. ``steps``: the flattened tree from a first call."""
    from repro_torch.core.draws import _fill, _mix64
    if steps is None:
        node, steps, draws = {(): 0}, [], []
        for path, kind, _ in plan.entries:
            for depth in range(1, len(path) + 1):
                if path[:depth] not in node:
                    node[path[:depth]] = len(node)
                    op = path[depth - 1]
                    arg = (op[2] if op[0] == "split" else _mix64(
                        0xF01D0000_00000000 | (int(op[1]) & 0xFFFFFFFF)))
                    steps.append((node[path[:depth - 1]], op[0], arg))
            draws.append((node[path], kind))
        steps = (steps, draws)
    tree, draws = steps
    words, mixed = [(root.key[0] << 32) | root.key[1]], {}
    for parent, op, arg in tree:
        base = mixed.get(parent)
        if base is None:
            base = mixed[parent] = _mix64(words[parent])
        words.append(_mix64(base + arg + 1) if op == "split"
                     else _mix64(base ^ arg))
    for (n, kind), buf in zip(draws, bufs):
        _fill(_mix64(words[n] ^ 0x5EED5EED5EED5EED), kind, buf, root.host)
    return steps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=40)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("fill_variants.py needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    _build.build_all()
    dev = torch.device("cuda")
    svc = cs.serve_setup(0, dev, None, None, buckets=cs.STREAM_BUCKETS)[0]
    plan = svc._s_route_pref[cs.STREAM_BUCKETS[-1]].plan
    walk_bufs, flat_bufs = plan.buffers(dev), plan.buffers(dev)
    root = svc._next_key()
    plan.fill(root, walk_bufs)
    steps = flat_fill(plan, root, flat_bufs)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(walk_bufs, flat_bufs))
    fills = {"walk": lambda k: plan.fill(k, walk_bufs),
             "flat": lambda k: flat_fill(plan, k, flat_bufs, steps)}
    ms = {"walk": [], "flat": []}
    for r in range(args.pairs + 2):
        for name in ("walk", "flat") if r % 2 == 0 else ("flat", "walk"):
            key = svc._next_key()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fills[name](key)
            ms[name].append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
    ms = {k: v[2:] for k, v in ms.items()}          # warm-up pairs dropped
    wins = {k: sum(a < b for a, b in zip(ms[k], ms[o]))
            for k, o in (("walk", "flat"), ("flat", "walk"))}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out = dict(card=smi, entries=len(plan.entries), bitwise=bitwise,
               pairs=args.pairs,
               **{f"{k}_ms_median": statistics.median(v)
                  for k, v in ms.items()},
               **{f"{k}_ms_min": min(v) for k, v in ms.items()},
               wins=wins)
    print(smi)
    print(json.dumps(out))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0 if bitwise else 1


if __name__ == "__main__":
    sys.exit(main())
