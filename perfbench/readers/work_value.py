"""A number the driver counted or timed in the window, as it stands
(``work["<key>"]``): harness timestamps, CUDA events or counts."""


def read(ctx, trace, spec):
    return ctx.work.get(spec["key"])
