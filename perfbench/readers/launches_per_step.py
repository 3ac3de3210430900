"""Kernels launched per step in the traced window: the trace's kernel
count over the steps the window held (``work["steps"]``)."""


def read(ctx, trace, spec):
    steps = ctx.work.get("steps")
    if trace is None or not steps or not trace.kernels:
        return None
    return len(trace.kernels) / steps
