"""train_dev.rays_per_s: in a training cell whose host sets the pace, the
rays of every train_step completed in the untraced window over the
window's wall time (it ends at a torch.cuda.synchronize()), as
train_rays_per_s reads it where that is an end-to-end metric."""


def read(ctx):
    return ctx.window["rays_per_s"]
