"""The whole step's share of the card's bf16 peak over the step's device
time: the aggregator's MLP operations a step needs for its inputs (block1,
block3 and alpha on the rows with a nonzero weight, the color head on the
live shading samples, x 3 for forward and backward), counted in the traced
stretch, over the device's busy time a step in that stretch, over
989 TFLOP/s. It bounds the kernels' roofline shares of the same cell."""
from portbench.cell import mlp_dims
from portbench.counting import PEAK_BF16, color_flops, decode_flops

PASSES = 3


def read(ctx):
    if ctx.trace is None or not ctx.calls.k3 or ctx.stretch_units <= 0 \
            or ctx.trace.busy_s <= 0:
        return None
    dims = mlp_dims(ctx.cell.raw["agg"])["color"]
    flops = sum(decode_flops(c["rows"], c["widths"])
                + color_flops(c["live"], dims) for c in ctx.calls.k3)
    return 100.0 * PASSES * flops / ctx.trace.busy_s / PEAK_BF16
