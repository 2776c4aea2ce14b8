"""Device microseconds of the kernels a request launches: the kernel
records of the traced window and its drain, over the requests submitted in
the window."""


def read(ctx):
    kernels = ctx.trace.kernels()
    if not kernels or not ctx.attempted:
        return None
    return sum(e - s for _, s, e in kernels) / ctx.attempted * 1e6
