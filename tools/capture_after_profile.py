#!/usr/bin/env python3
"""Whether a CUDA graph capture made right after a profiler window is
broken from another thread, by the capture's error mode.

    python3 tools/capture_after_profile.py [--rounds N] [--out FILE]

Each round opens ``repro_torch.profiling.cuda_profile`` (the profiler window:
markers, a drain, an empty session after it) over replays of a captured
graph and eager kernels, as phase ``stream`` profiles its passes, and then
at once captures a chain of small kernels, in the global error mode on
even rounds and the thread-local mode on odd ones, and replays it. Counts
the captures that raised, by mode, with the first error of each. Prints
one JSON line with the counts and the card's name and power limit. Needs
one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
MODES = ("global", "thread_local")


def chain(x, w):
    """A short chain of small kernels, as a routing act launches them."""
    y = x
    for _ in range(8):
        y = (y @ w).tanh_() * 0.5 + x
    return y


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--out", help="also write the record here (JSON)")
    args = ap.parse_args()
    sys.path[:0] = [str(HERE), str(HERE / "src")]
    import torch
    if not torch.cuda.is_available():
        print("capture_after_profile: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import profiling
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((16, 64), generator=gen, device="cuda")
    w = torch.randn((64, 64), generator=gen, device="cuda") / 8
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain(x, w)
    torch.cuda.current_stream().wait_stream(side)
    profiled = torch.cuda.CUDAGraph()
    with torch.cuda.graph(profiled):
        chain(x, w)
    want = chain(x, w)
    failed = {m: 0 for m in MODES}
    first = {m: None for m in MODES}
    for rnd in range(args.rounds):
        with profiling.cuda_profile():
            for _ in range(20):
                profiled.replay()
                chain(x, w)
            torch.cuda.synchronize()
        mode = MODES[rnd % 2]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode=mode):
                got = chain(x, w)
            graph.replay()
            torch.cuda.synchronize()
            cs.check(torch.allclose(got, want), f"round {rnd}: replay off")
        except RuntimeError as e:
            failed[mode] += 1
            first[mode] = first[mode] or f"round {rnd}: {e}"[:300]
            torch.cuda.synchronize()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    rec = dict(rounds={m: len(range(i, args.rounds, 2))
                       for i, m in enumerate(MODES)},
               failed=failed, first_error=first, card=card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
