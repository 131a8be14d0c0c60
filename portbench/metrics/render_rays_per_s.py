"""render_rays_per_s: rays of every whole frame rendered in the window,
over the window's wall time (it ends at the end of a frame)."""


def read(ctx):
    return ctx.window["rays_per_s"]
