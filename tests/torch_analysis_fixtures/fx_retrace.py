"""Seeded capture-retrace hazards + clean twins.

Parsed by tests/test_torch_analysis.py, never executed.
"""
import functools

import torch


def bad_capture_per_step(fns, x):
    graphs = []
    for f in fns:
        g = torch.cuda.CUDAGraph()  # PLANT: retrace/capture-in-loop
        with torch.cuda.graph(g):  # PLANT: retrace/capture-in-loop
            f(x)
        graphs.append(g)
    return graphs


def bad_compile_per_step(fns, xs):
    outs = []
    for f, x in zip(fns, xs):
        outs.append(torch.compile(f)(x))  # PLANT: retrace/capture-in-loop
    return outs


class BadTicker:
    def __init__(self, x):
        self.tick = 0
        self.x = x
        self.graph = torch.cuda.CUDAGraph()
        self.out = self._capture(functools.partial(self.step, 2.0))

    def _capture(self, body):
        with torch.cuda.graph(self.graph):
            return body()

    def step(self, scale):
        return self.x * scale + self.tick  # PLANT: retrace/frozen-host-value

    def advance(self):
        self.tick += 1
        self.graph.replay()
        return self.out


# --------------------------- clean twins -----------------------------------

def ok_capture_once(f, xs, buf):
    g = torch.cuda.CUDAGraph()   # hoisted: one capture, replayed per item
    with torch.cuda.graph(g):
        out = f(buf)
    for x in xs:
        buf.copy_(x)
        g.replay()
    return out


class OkTicker:
    def __init__(self, x):
        self.tick = 0
        self.tick_dev = torch.zeros((), dtype=torch.int32)
        self.x = x
        self.graph = torch.cuda.CUDAGraph()
        self.out = self._capture(functools.partial(self.step, 2.0))

    def _capture(self, body):
        with torch.cuda.graph(self.graph):
            return body()

    def step(self, scale):
        # a device tensor written in place: the graph reads it every replay
        return self.x * scale + self.tick_dev

    def advance(self):
        self.tick += 1               # host mirror, read outside the graph
        self.tick_dev.add_(1)
        self.graph.replay()
        return self.out, f"tick {self.tick}"
