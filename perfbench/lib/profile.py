"""The device trace of a measured window, reduced to what the metrics read.

The window arithmetic is a copy of the port's ``profiling.py``: CUPTI hands
its records over late, so the window is padded at both ends by a marker
kernel (``torch.cuda._sleep``), the host waits ``DRAIN_S`` before it
closes, and an empty session follows it. A window is whole when its last
device event is the closing marker.

``Trace`` keeps each device kernel as (name, start, end) in seconds on the
host's ``perf_counter`` clock: the opening marker is launched right after a
sync at a known host time, so device time maps onto the host clock to
within a launch (tens of microseconds), enough to say what the host was
doing during an idle gap of a millisecond.
"""
from __future__ import annotations

import contextlib
import re
import time

MARKER = "spin_kernel"
DRAIN_S = 0.02
MARKER_CYCLES = 1 << 21


class Trace:
    """Device kernels of one window: ``kernels`` [(name, t0, t1)] on the
    host clock, ``t0`` / ``t1`` the window's host bounds, ``whole``."""

    def __init__(self, kernels, t0: float, t1: float, whole: bool):
        self.kernels, self.t0, self.t1, self.whole = kernels, t0, t1, whole

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        """Seconds in which some kernel ran (the union of intervals)."""
        busy, end = 0.0, -float("inf")
        for _, a, b in sorted(self.kernels, key=lambda k: k[1]):
            if b <= end:
                continue
            busy += b - max(a, end)
            end = b
        return busy

    def gaps(self) -> list:
        """(start, end) of every interval inside the window with no
        kernel running."""
        out, end = [], self.t0
        for _, a, b in sorted(self.kernels, key=lambda k: k[1]):
            if a > end:
                out.append((end, a))
            end = max(end, b)
        if self.t1 > end:
            out.append((end, self.t1))
        return out

    def kernel_seconds(self, patterns) -> tuple[float, int]:
        """(seconds, launches) of the kernels whose name matches any of
        the regular expressions ``patterns``."""
        rx = [re.compile(p) for p in patterns]
        secs, n = 0.0, 0
        for name, a, b in self.kernels:
            if any(r.search(name) for r in rx):
                secs += b - a
                n += 1
        return secs, n

    def top_ops(self, k: int = 10) -> list:
        by: dict[str, float] = {}
        for name, a, b in self.kernels:
            by[name] = by.get(name, 0.0) + (b - a)
        return sorted(([n[:120], s] for n, s in by.items()),
                      key=lambda e: -e[1])[:k]

    def idle_by_host(self, spans, k: int = 10) -> list:
        """The idle seconds summed by what the host was doing when each
        gap began (``spans``: [(label, t0, t1)] on the host clock; the
        innermost span that holds the gap's start names it)."""
        by: dict[str, float] = {}
        spans = sorted(spans, key=lambda s: s[1])
        for a, b in self.gaps():
            label = "host:other"
            for name, s0, s1 in spans:
                if s0 <= a < s1:
                    label = "host:" + name
                elif s0 > a:
                    break
            by[label] = by.get(label, 0.0) + (b - a)
        return sorted(([n, s] for n, s in by.items()),
                      key=lambda e: -e[1])[:k]


@contextlib.contextmanager
def traced_window(out: dict):
    """Profile the device over the ``with`` body; on exit ``out["trace"]``
    holds its ``Trace``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        time.sleep(DRAIN_S)
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    markers = sorted((e for e in dev if MARKER in e.name),
                     key=lambda e: e.time_range.start)
    whole = bool(dev) and MARKER in max(
        dev, key=lambda e: e.time_range.start).name
    base = markers[0].time_range.start if markers else min(
        (e.time_range.start for e in dev), default=0.0)
    kernels = [(e.name, h0 + (e.time_range.start - base) * 1e-6,
                h0 + (e.time_range.end - base) * 1e-6)
               for e in dev if MARKER not in e.name]
    out["trace"] = Trace([(n, max(a, t0), min(b, t1)) for n, a, b in kernels
                          if b > t0 and a < t1], t0, t1, whole)
