"""Kernel device time on the card from ``torch.profiler`` windows that keep
their records (``chip_smoke.py``, the dry-runs, the card tests and the
tools take their profiles here).

CUPTI hands its activity records over late. On an H100 a window closed
right after its last sync lost, at random, the records of its last
milliseconds (a whole CUDA graph replay, or part of one), and the first
kernel's record in most windows; records handed over after a window
closed landed in the next one. ``cuda_profile`` pads both ends of a
window with a marker kernel, waits before closing it and follows it with
an empty session; ``window_whole`` says whether the closing marker was
recorded, and so everything before it; ``whole_profile`` takes a window
again while it is not whole.
"""
from __future__ import annotations

import contextlib
import math
import time

import torch

# the kernel of ``torch.cuda._sleep``, which pads a window's two ends, and
# the host's wait before the window closes
MARKER = "spin_kernel"
DRAIN_S = 0.02


@contextlib.contextmanager
def cuda_profile():
    """``torch.profiler`` over the card's activity only, padded at both
    ends by a marker kernel (``MARKER``, about a millisecond of spinning,
    synced), the host waiting ``DRAIN_S`` before the window closes, then
    an empty session, which takes the records handed over after the
    window closed."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1 << 21)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()
        torch.cuda._sleep(1 << 21)
        torch.cuda.synchronize()
        time.sleep(DRAIN_S)
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda.synchronize()


def device_events(prof) -> list:
    """The profile's averaged events on the device only (so a host op and
    its kernel are not both counted), by name, the markers left out."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and MARKER not in e.key]


def window_whole(prof) -> bool:
    """Whether the profile recorded ``cuda_profile``'s closing marker: the
    device event that starts last is a marker."""
    from torch.autograd import DeviceType
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return bool(dev) and MARKER in max(
        dev, key=lambda e: e.time_range.start).name


def kernel_events(prof) -> list:
    """(name, device us, launches) of every device kernel in a profile,
    the markers left out."""
    out = []
    for e in device_events(prof):
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            out.append((e.key, us, e.count))
    return out


def whole_profile(run, attempts: int = 3):
    """``run()`` under ``cuda_profile``, taken again, ``run()`` with it, up
    to ``attempts`` times while the window records no kernel or is not
    whole. Returns the last window's profile."""
    for _ in range(attempts):
        with cuda_profile() as prof:
            run()
            torch.cuda.synchronize()
        if kernel_events(prof) and window_whole(prof):
            break
    return prof


# the least host time a profiled window holds: one-call windows of the
# router dry-run's route share (0.1 ms) recorded no event at all in most
# tries on an H100, padded or not, where windows of 10 ms and more kept
# theirs
WINDOW_MS = 50.0


def timed(fn, calls: int = 5) -> dict:
    """Host ms a call of ``fn`` (ending in a sync); device ms by kernel a
    call, the mean over a whole profiler window (``whole_profile``) of as
    many calls as fill ``WINDOW_MS``; the peak memory of a call."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    peak = torch.cuda.max_memory_allocated()
    n = max(1, math.ceil(WINDOW_MS / ms))

    def run():
        for _ in range(n):
            fn()
    by_kernel = {k: us / 1e3 / n for k, us, _ in
                 kernel_events(whole_profile(run))}
    return {"ms": ms, "device_ms": sum(by_kernel.values()),
            "device_ms_by_kernel": by_kernel, "peak_bytes": peak,
            "profiled_calls": n}
