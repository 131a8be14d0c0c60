"""K4's share of its roofline: the least time its calls in the traced
stretch could take (portbench/counting.decode_bound with backward, on the
rows of each decode under a gradient) over the device time of its
kernels."""
from portbench.counting import decode_bound

# K4's kernels on every route: the tensor-core and f32 row and dW kernels
# and reductions, their live-list passes, the general kernels
KERNELS = ("fused_decode_bwd", "live_flags<true>", "live_compact<true>",
           "k4_")


def read(ctx):
    if ctx.trace is None:
        return None
    calls = [c for c in ctx.calls.k3 if c["grad"]]
    t = ctx.trace.seconds(KERNELS)
    if not calls or t <= 0:
        return None
    bound = sum(decode_bound(c["rows"], c["M"], c["widths"], backward=True)[2]
                for c in calls)
    return 100.0 * bound / t
