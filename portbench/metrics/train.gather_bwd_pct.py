"""The point payload gather's backward (models/points.gather_points: the
index_add_ scatter-add of index_select's backward) as a share of the
traced stretch's device time, found by kernel name."""

KERNELS = ("indexFuncLargeIndex", "indexFuncSmallIndex")


def read(ctx):
    if ctx.trace is None:
        return None
    total = ctx.trace.kernel_total()
    t = ctx.trace.seconds(KERNELS)
    if total <= 0 or t <= 0:
        return None
    return 100.0 * t / total
