"""What a driver is handed and what it hands back: the cell's files, the
seed, the device, the clock, host spans, the optional device trace, and
the record of the work done in the window that the readers turn into
per-layer metrics."""
from __future__ import annotations

import time

from . import profile


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Tracer:
    """The device trace of part of the window (``--trace 1``); inactive
    otherwise, and on a CPU."""

    def __init__(self, active: bool):
        self.active, self.trace, self._cm, self._out = active, None, None, {}

    def start(self) -> None:
        if self.active and self._cm is None:
            self._cm = profile.traced_window(self._out)
            self._cm.__enter__()

    def stop(self) -> None:
        if self._cm is not None:
            self._cm.__exit__(None, None, None)
            self._cm, self.trace = None, self._out["trace"]

    @property
    def running(self) -> bool:
        return self._cm is not None


def trace_step(ctx, t0: float) -> bool:
    """After a batch or step of the window: whether the trace holds it;
    the trace stops once it has covered the traffic's ``trace_seconds``
    from the window's start ``t0``."""
    if not ctx.tracer.running:
        return False
    if ctx.now() >= t0 + ctx.traffic["trace_seconds"]:
        ctx.tracer.stop()
    return True


class Ctx:
    """One run of one cell."""

    def __init__(self, *, cell: str, config: dict, traffic: dict,
                 limits: dict, seed: int, seconds: float, trace: bool,
                 device, t_process: float):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.limits, self.seed, self.seconds = limits, seed, seconds
        self.device, self.t_process = device, t_process
        self.tracer = Tracer(trace and device.type == "cuda")
        self.trace_on = trace
        self.spans: list = []          # (label, t0, t1) on the host clock
        self.work: dict = {}           # counts and bounds of the window
        self.e2e: dict = {}            # end-to-end metrics by name
        self.attempted = self.failed = 0
        self.setup_s = None

    @staticmethod
    def now() -> float:
        return time.perf_counter()

    def span(self, label: str, t0: float, t1: float) -> None:
        if self.trace_on:
            self.spans.append((label, t0, t1))

    def window_started(self) -> float:
        """Mark the first timed request: set-up ends here."""
        t = self.now()
        self.setup_s = t - self.t_process
        return t
