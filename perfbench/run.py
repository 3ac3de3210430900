"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``. Its
configuration file, its traffic file (``perfbench/traffic/<traffic>.json``,
whose ``driver`` names the module under ``perfbench/drivers/`` that runs
it), its limits (``perfbench/workloads/<cell>.json``) and its per-layer
metrics (``perfbench/metrics/<name>.json``, each naming a reader under
``perfbench/readers/``, kernel-name patterns in ``<name>.d/``) are found
by name, so a new cell or metric adds files and edits none.

A run sets up (weights and traffic from the seed, on the device; every
shape the traffic uses warmed up), measures for ``--seconds``, reads the
peak memory, frees the program's state, checks the window's outputs
against the plain reference under ``perfbench/reference/`` and prints one
JSON line last on standard output; each number compared, with its limit,
ends standard error. With ``--trace 1`` the metrics are the cell's
per-layer ones, read from the window's device trace and host spans.
It exits 2 without a result when no card (or too few) is visible, and 3
when the process holds JAX or the JAX package after the window.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> list:
    """Top-level names (the part before the first dot, whole) of ``names``
    that are JAX or the JAX package."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def cell_files(name: str) -> dict:
    """The manifest's entries and the files of cell ``name``."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}: one of {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]

    def ours(m):
        return "workloads" not in m or name in m["workloads"]
    return dict(
        cell=cell,
        config=json.loads((ROOT / conf["file"]).read_text()),
        traffic=json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                           .read_text()),
        limits=json.loads((BENCH / "workloads" / f"{name}.json")
                          .read_text())["limits"],
        end_to_end=[m for m in manifest["end_to_end"] if ours(m)],
        per_layer=[m for m in manifest["per_layer"] if ours(m)])


def metric_spec(name: str) -> dict:
    spec = json.loads((BENCH / "metrics" / f"{name}.json").read_text())
    d = BENCH / "metrics" / f"{name}.d"
    spec["patterns"] = [ln.strip() for f in sorted(d.glob("*.txt"))
                        for ln in f.read_text().splitlines()
                        if ln.strip() and not ln.startswith("#")] \
        if d.is_dir() else []
    return spec


def judge(checks: dict, limits: dict) -> bool:
    """Correct when every limit has a finite number and none exceeds it."""
    return all(k in checks and math.isfinite(checks[k]) and checks[k] <= lim
               for k, lim in limits.items())


def finite(v):
    return v if v is not None and math.isfinite(v) else None


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def setup_env() -> None:
    """Caches at fixed paths inside the checkout; no JAX through a
    library that would load it by itself."""
    cache = ROOT / "build" / "perfbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    args = parse_args(argv)
    files = cell_files(args.workload)
    setup_env()
    import torch
    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" visible", file=sys.stderr)
        return 2
    from perfbench.lib import ctx as ctx_lib
    from perfbench.reference import dense
    dev = torch.device("cuda", 0)
    driver = importlib.import_module(
        "perfbench.drivers." + files["traffic"]["driver"])
    ctx = ctx_lib.Ctx(cell=args.workload, config=files["config"],
                      traffic=files["traffic"], limits=files["limits"],
                      seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=dev,
                      t_process=T_PROCESS)
    st = driver.setup(ctx)
    # no cyclic collection inside the window: its pauses are the
    # harness's, not the program's
    gc.collect()
    gc.disable()
    driver.window(ctx, st)
    gc.enable()
    peak = torch.cuda.max_memory_allocated(dev)
    driver.release(ctx, st)
    with dense.precision():
        checks = driver.check(ctx, st)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"the process holds {bad} after the window", file=sys.stderr)
        return 3
    result = {"correct": judge(checks, ctx.limits),
              "attempted": ctx.attempted, "failed": ctx.failed}
    metrics = {}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": chips, "memory_peak_bytes": int(peak)}
    if args.trace:
        trace = ctx.tracer.trace
        for m in files["per_layer"]:
            spec = metric_spec(m["name"])
            reader = importlib.import_module(
                "perfbench.readers." + spec["reader"])
            v = reader.read(ctx, trace, spec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device["busy_s"] = trace.busy_s()
        device["window_s"] = trace.window_s
        result["breakdown"] = {
            "device_ops": trace.top_ops(),
            "idle_gaps": trace.idle_by_host(ctx.spans)}
    else:
        values = dict(ctx.e2e, setup_s=ctx.setup_s)
        for m in files["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device
    result["checks"] = {k: {"value": finite(checks.get(k)), "limit": lim}
                        for k, lim in ctx.limits.items()}
    for k in sorted(set(checks) - set(ctx.limits)):
        print(f"reading {k} = {checks[k]!r} (no limit)", file=sys.stderr)
    for k, lim in ctx.limits.items():
        print(f"check {k} = {checks.get(k)!r} (limit {lim!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
