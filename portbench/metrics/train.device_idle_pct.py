"""The device's idle share of the traced stretch: 100 x (1 - the union of
the kernel intervals / the stretch's synchronized host wall time)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0 or not ctx.trace.kernels:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
