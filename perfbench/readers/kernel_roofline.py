"""A kernel's share of its roofline, in %: the least time the chip could
take for the window's calls (``work["<bound>"]``, counted from their
shapes by ``lib/roofline.py``) over the device time of the kernels whose
names match the metric's patterns (``metrics/<name>.d/*.txt``). Nothing
to read when no such kernel ran."""


def read(ctx, trace, spec):
    if trace is None or ctx.work.get(spec["bound"]) is None:
        return None
    secs, n = trace.kernel_seconds(spec["patterns"])
    if n == 0 or secs <= 0:
        return None
    return 100.0 * ctx.work[spec["bound"]] / secs
