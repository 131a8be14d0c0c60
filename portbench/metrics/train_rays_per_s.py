"""train_rays_per_s: rays of every train_step completed in the window, over
the window's wall time (it ends at a torch.cuda.synchronize())."""


def read(ctx):
    return ctx.window["rays_per_s"]
