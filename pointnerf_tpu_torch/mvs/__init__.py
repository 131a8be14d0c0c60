"""The MVS stack (counterpart of `pointnerf_tpu/mvs/`): MVSNet, the
geometric filter, the point embedding, visual-hull masking and the
reference-checkpoint import, and the MVSNeRF volume renderer."""
from .filter import check_geometric_consistency, filter_by_masks
from .mvsnet import CostRegNet, FeatureNet, MVSNet, depth_regression, homo_warp
from .points_init import MvsPointsInit
from .mvsnerf import (MVSNERF_DECODERS, MVSNeRFDecoder, ReferenceMVSNeRF,
                      RendererAttention, RendererColorFusion, RendererLinear,
                      RendererOurs, render_mvsnerf)
