"""Seeded capture-hazard violations (capture-reachable rules) + clean
twins.

Parsed by tests/test_torch_analysis.py, never executed. The service
captures its programs as ``RouterService`` does: ``build`` hands each body
through ``functools.partial`` to ``_capture``, whose graph block calls it.
"""
import functools
import gc

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding import routing_rules as rr


def _helper(x):
    # reachable only through step's capture: the fixpoint must carry the
    # operand across the bare-name call edge
    return float(x.mean())  # PLANT: trace-hazard/host-cast


class Service:
    def __init__(self, buf, buckets):
        self.buf = buf
        self.graph_pool = None
        self.progs = self.build_all(buckets)

    def _capture(self, body, b: int):
        gc.collect()               # before the capture: fine
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.graph_pool):
            out = body(None)
            total = out.sum().item()  # PLANT: trace-hazard/host-sync
        return graph, out, total

    def build_all(self, buckets):
        def step(b, draws):
            x = self.buf[b]
            s = x.sum()
            gc.collect()  # PLANT: trace-hazard/capture-unsafe-call
            dist.all_reduce(s)  # PLANT: trace-hazard/capture-unsafe-call
            rows = rr.gather_rows(x, None, 2)  # PLANT: trace-hazard/capture-unsafe-call
            if s > 0:  # PLANT: trace-hazard/python-control-flow
                x = -x
            n = int(x.sum())  # PLANT: trace-hazard/host-cast
            torch.cuda.synchronize()  # PLANT: trace-hazard/host-sync
            host = np.asarray(x)  # PLANT: trace-hazard/host-sync
            live = torch.nonzero(x)  # PLANT: trace-hazard/host-sync
            back = x.cpu()  # PLANT: trace-hazard/host-sync
            return x, rows, n, host, live, back, _helper(x)

        def step_ok(b, draws, with_pref: bool, *, scale=1.0):
            # clean twin: shape reads, static flags, None guards,
            # metadata reads and device-side selects
            x = self.buf[b]
            n = int(x.shape[0])
            if n > 4:
                x = x[:4]
            if draws is not None:
                x = x + draws.normal(x.shape, x.device)
            if with_pref:
                x = x * 2.0
            if scale != 1.0:
                x = x * scale
            if x.data_ptr() == 0:
                x = x + 1.0
            return torch.where(x > 0, x, -x)

        def build(body):
            progs = {}
            for b in buckets:
                fn = functools.partial(body, b)
                progs[b] = self._capture(fn, b)
            return progs

        return build(step), build(lambda b, dr: step_ok(b, dr, False))


def fwd(x):
    return x.tolist()  # PLANT: trace-hazard/host-sync


def graphed(x):
    return torch.cuda.make_graphed_callables(fwd, (x,))


# --------------------------- clean twins -----------------------------------

def uncaptured_report(x):
    # host code outside any capture: syncing here is the caller's business
    gc.collect()
    return x.sum().item(), x.cpu(), int(x.sum())
