"""setup_s: from the start of the process to the start of the window (the
scene, the weights, the grid and tables, a checkout's first kernel build,
the warm-up of the traffic's shapes)."""


def read(ctx):
    return ctx.setup_s
