"""K1's share of its roofline: the least time its calls in the traced
stretch could take (portbench/counting.k1_bound from what each call's
table rows and slots hold) over the device time of its kernels."""
from portbench.counting import k1_bound, k1_stats

# K1's kernels: the run path, the warp path and the wide path's passes
KERNELS = ("knn_select_runs_kernel", "knn_select_warp_kernel",
           "knn_select_wide")


def read(ctx):
    if ctx.trace is None or not ctx.calls.k1:
        return None
    t = ctx.trace.seconds(KERNELS)
    if t <= 0:
        return None
    bound = 0.0
    for nbr_xyz, dslot, ok, pid, K in ctx.calls.k1:
        st = k1_stats(nbr_xyz, dslot, ok, pid)
        bound += k1_bound(st, dslot.shape[0], nbr_xyz.shape[1] // 3, K)[2]
    return 100.0 * bound / t
