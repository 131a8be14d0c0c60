"""K2's share of its roofline: the least time its calls in the traced
stretch could take (portbench/counting.k2_bound) over the device time of
its kernels."""
from portbench.counting import k2_bound

KERNELS = ("fused_march_kernel", "fused_march_wide_kernel")


def read(ctx):
    if ctx.trace is None or not ctx.calls.k2:
        return None
    t = ctx.trace.seconds(KERNELS)
    if t <= 0:
        return None
    return 100.0 * sum(k2_bound(*c)[2] for c in ctx.calls.k2) / t
