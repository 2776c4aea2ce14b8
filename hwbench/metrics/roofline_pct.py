"""The kernels' share of their roofline: the sum over the traced kernel
launches of each launch's least time on an H100 SXM (``hwbench.roofline``,
the work of the function the kernel computes, ``work/<kernel>.py``, at the
request's size) divided by the sum of their device times, in percent.  A
kernel whose work is not counted (the second-pass reduce) adds its device
time and no least time."""

from collections import Counter

from hwbench.measure import kernel_key
from hwbench.roofline import least_seconds


def read(ctx):
    kernels = ctx.trace.kernels()
    spent = sum(e - s for _, s, e in kernels)
    launches = Counter(kernel_key(name) for name, _, _ in kernels)
    least = sum(n * least_seconds(ctx.work, k) for k, n in launches.items())
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
