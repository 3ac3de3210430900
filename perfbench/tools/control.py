"""Readings for the limits of a cell's check, on the card: for each seed,
one set-up and a window at the cell's own load, then the numbers the run
compares, once for the program's outputs and once for the control (the
reference computed in the precision below the configuration's: TF32 for
float32 with TF32 off, float8 e4m3 for bfloat16) put in its place.

    python3 perfbench/tools/control.py --workload <cell> --seeds 1,2,3 --seconds 8

One JSON line a seed: {"seed", "program": {...}, "control": {...}}.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import run  # noqa: E402

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    files = run.cell_files(args.workload)
    run.setup_env()
    import importlib

    import torch

    from perfbench.lib.ctx import Ctx
    from perfbench.reference import dense
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    driver = importlib.import_module(
        "perfbench.drivers." + files["traffic"]["driver"])
    mode = CONTROL[files["config"]["dtype"]]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = Ctx(cell=args.workload, config=files["config"],
                  traffic=files["traffic"], limits=files["limits"],
                  seed=seed, seconds=args.seconds, trace=False, device=dev,
                  t_process=t0)
        st = driver.setup(ctx)
        driver.window(ctx, st)
        driver.release(ctx, st)
        with dense.precision():
            t1 = time.perf_counter()
            prog = driver.check(ctx, st)
            t2 = time.perf_counter()
            ctrl = driver.check(ctx, st, mode)
        print(json.dumps({"seed": seed, "control_mode": mode,
                          "program": prog, "control": ctrl,
                          "e2e": ctx.e2e, "setup_s": ctx.setup_s,
                          "check_s": t2 - t1,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del st, ctx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
