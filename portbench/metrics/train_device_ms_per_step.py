"""train_device_ms_per_step: the device's busy time over every train_step of
the window, per step, in ms. The busy time is the union of the device's
intervals (kernels, copies, sets) that the profiler records on CUDA activity
alone over the whole window (portbench/trace.WindowMeter); the window's
steps are all the steps it drives."""


def read(ctx):
    busy = ctx.window.get("device_busy_s")
    if not busy or ctx.window["units"] <= 0:
        return None
    return 1e3 * busy / ctx.window["units"]
