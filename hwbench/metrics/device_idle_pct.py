"""The share of the measured window in which no kernel or copy ran on the
card: 1 - (the union of the device intervals) / the window, in percent,
both from the one traced window."""


def read(ctx):
    lo, hi = ctx.window
    return 100.0 * (1.0 - ctx.busy_s / (hi - lo))
