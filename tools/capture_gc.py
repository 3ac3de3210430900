#!/usr/bin/env python3
"""Whether Python's garbage collector, run inside a CUDA graph capture,
breaks the capture when the garbage holds another service's graphs.

    python3 tools/capture_gc.py [--rounds N] [--out FILE]

Each round builds a streaming ``RouterService`` (``chip_smoke.serve_setup``,
one bucket of 32 rows: four captured graphs) and drops it. The service's
closures refer to it, so only the cyclic collector frees it and its
graphs. Then a chain of small kernels is captured in the thread-local
error mode and replayed, with the collection made at one of three points
(``--modes``): ``inside``, ``gc.collect()`` in the middle of the capture;
``before``, ``gc.collect()`` just before it; ``disabled``, the collector
off during the capture (as ``RouterService._capture`` runs it) and the
collection made after it. The collector is off for the rest of the run, so
it runs only where a mode says. Counts the captures that raised, by mode,
with the first error of each, and for each collection the objects it
freed and whether the service was among them.
Prints one JSON line with the counts and the card's name and power limit.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import weakref
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
MODES = ("inside", "before", "disabled")


def chain(x, w, mid=None):
    """A short chain of small kernels, as a routing act launches them;
    ``mid`` is called halfway."""
    y = x
    for i in range(8):
        if i == 4 and mid is not None:
            mid()
        y = (y @ w).tanh_() * 0.5 + x
    return y


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--modes", nargs="*", choices=MODES, default=list(MODES))
    ap.add_argument("--out", help="also write the record here (JSON)")
    args = ap.parse_args()
    sys.path[:0] = [str(HERE), str(HERE / "src")]
    import torch
    if not torch.cuda.is_available():
        print("capture_gc: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((16, 64), generator=gen, device=dev)
    w = torch.randn((64, 64), generator=gen, device=dev) / 8
    want = chain(x, w)
    gc.collect()
    gc.disable()
    failed = {m: 0 for m in args.modes}
    first = {m: None for m in args.modes}
    freed = {m: [] for m in args.modes}
    for rnd in range(args.rounds):
        for mode in args.modes:
            svc = cs.serve_setup(rnd, dev, None, None, buckets=(32,))[0]
            cs.check(svc.compiled_program_counts().get("captures", 0) > 0,
                     "the service captured no graph")
            alive = weakref.ref(svc)
            del svc
            torch.cuda.synchronize()
            collect = lambda: freed[mode].append(
                (gc.collect(), alive() is None))
            if mode == "before":
                collect()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph,
                                      capture_error_mode="thread_local"):
                    got = chain(x, w, collect if mode == "inside" else None)
                graph.replay()
                torch.cuda.synchronize()
                cs.check(torch.allclose(got, want),
                         f"{mode} {rnd}: replay off")
            except RuntimeError as e:
                failed[mode] += 1
                first[mode] = first[mode] or f"round {rnd}: {e}"[:300]
                torch.cuda.synchronize()
            if mode == "disabled":
                collect()
            gc.collect()
    gc.enable()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    rec = dict(rounds=args.rounds, failed=failed, first_error=first,
               objects_freed=freed, card=card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
