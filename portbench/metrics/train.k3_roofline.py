"""K3's share of its roofline: the least time its calls in the traced
stretch could take (portbench/counting.decode_bound on each call's rows
with a nonzero weight) over the device time of its kernels."""
from portbench.counting import decode_bound

# K3's kernels on every route: the tensor-core and f32 kernels, their
# live-list passes, the general kernels
KERNELS = ("fused_decode_tc_fwd", "fused_decode_f32", "live_flags<false>",
           "live_compact<false>", "k3_tc", "k3_cc")


def read(ctx):
    if ctx.trace is None or not ctx.calls.k3:
        return None
    t = ctx.trace.seconds(KERNELS)
    if t <= 0:
        return None
    bound = sum(decode_bound(c["rows"], c["M"], c["widths"])[2]
                for c in ctx.calls.k3)
    return 100.0 * bound / t
