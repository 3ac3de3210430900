"""The knee of an open-loop router cell: one set-up, then a window at each
offered rate in turn (``--rates``), each printing the offered rate, the
routed rate, the queries left unrouted at the window's end and the 95th
percentile. A rate is sustained when 99% of the queries due before the
window's last ``--settle`` seconds were routed inside the window (the
rest of the window's arrivals are still in flight at its end, whatever
the rate) and fewer queries than the top bucket are left unrouted. The
knee is the highest sustained rate.

    python3 perfbench/tools/sweep.py --workload router-prod.text-poisson \\
        --rates 1600,2000,2400 --seconds 10 --seed 5
"""
import argparse
import copy
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--settle", type=float, default=2.0)
    args = ap.parse_args(argv)
    rates = [float(r) for r in args.rates.split(",")]
    files = run.cell_files(args.workload)
    run.setup_env()
    import numpy as np
    import torch

    from perfbench.drivers import router_stream as drv
    from perfbench.lib import arrivals
    from perfbench.lib.ctx import Ctx
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    tr = copy.deepcopy(files["traffic"])
    tr["arrival"]["rate"] = max(rates)
    ctx = Ctx(cell=args.workload, config=files["config"], traffic=tr,
              limits={}, seed=args.seed, seconds=args.seconds, trace=False,
              device=torch.device("cuda", 0), t_process=time.perf_counter())
    st = drv.setup(ctx)
    n = st.times.shape[0]
    for i, rate in enumerate(rates):
        st.times = arrivals.arrival_times(tr["arrival"]["kind"], rate, n,
                                          args.seed * 31 + i)
        ctx.e2e, ctx.work = {}, {}
        drv.window(ctx, st)
        top = st.buckets[-1]
        due = st.t0 + st.times
        early = due < st.t_end - args.settle
        share = float(np.mean(st.done[early] <= st.t_end))
        ok = share >= 0.99 and ctx.work["backlog_at_end"] < top
        print(json.dumps({"rate": rate, "offered_qps": ctx.attempted
                          / args.seconds, **ctx.e2e,
                          "backlog_at_end": ctx.work["backlog_at_end"],
                          "batches": len(st.batches),
                          "routed_share_settled": share,
                          "sustained": bool(ok)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
