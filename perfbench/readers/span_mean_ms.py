"""The mean, in ms, of a harness span timed with a sync on both sides
(``work["span:<span>"]``, seconds a call)."""


def read(ctx, trace, spec):
    v = ctx.work.get("span:" + spec["span"])
    return 1e3 * sum(v) / len(v) if v else None
