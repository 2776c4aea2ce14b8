"""Milliseconds of the host prepare step during set-up (the harness's span
around ``Pricer.prepare``: the step tables and the prepared operands)."""


def read(ctx):
    return ctx.prepare_s * 1e3
