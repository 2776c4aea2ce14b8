"""Host microseconds a request spends in the pricer's run step (the
harness's ``run`` spans around each ``Pricer.run`` call: ``pricing`` and
the ``kernels.fused`` wrappers with their ctypes launches): the spans of
the traced window, clipped to it, over the requests submitted in it.  The
trace's active step opens at the window, so set-up and warm-up (the
library's load, the first request) are not in it."""


def read(ctx):
    lo, hi = ctx.window
    runs = ctx.trace.spans_in("run", lo, hi)
    if not ctx.attempted or not runs:
        return None
    return sum(e - s for s, e in runs) / ctx.attempted * 1e6
