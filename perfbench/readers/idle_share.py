"""The device's idle share of the traced window, in %: the time no
kernel ran over the window's length (``torch.profiler``'s trace)."""


def read(ctx, trace, spec):
    if trace is None or not trace.kernels or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
