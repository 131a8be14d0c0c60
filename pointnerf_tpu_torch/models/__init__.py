"""Point cloud, aggregator, ray march and renderer of the PyTorch port
(counterpart of `pointnerf_tpu/models/`, exporting the same names but the
`ray_march` function, which would hide the `ray_march` module)."""
from .aggregator import AggOutput, aggregate, init_aggregator_params
from .losses import compute_losses, mse2psnr
from .points import (PointCloud, PointCloudStatic, SampledPoints, gather_points,
                     grow, make_point_cloud, prune, round_capacity)
from .ray_march import (BLEND_FUNCS, RENDER_FUNCS, TONEMAP_FUNCS,
                        alpha_ray_march)
from .renderer import RayBatch, RenderOutput, render_rays
