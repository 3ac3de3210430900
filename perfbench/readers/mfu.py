"""The whole step's share of the chip's peak over the traced window, in %:
``work["<bound>"]`` (the least time of the window's model work at the
configuration's peak, counted from shapes) over the window's length."""


def read(ctx, trace, spec):
    if trace is None or trace.window_s <= 0 or not ctx.work.get(spec["bound"]):
        return None
    return 100.0 * ctx.work[spec["bound"]] / trace.window_s
