"""The neural point cloud: positions + per-point payloads as torch tensors.

Counterpart of `pointnerf_tpu/models/points.py` (`PointCloud`,
`PointCloudStatic`, `round_capacity`, `make_point_cloud`, `SampledPoints`,
`gather_points`). The cloud is padded to a fixed capacity: `num_active`
points are live, the tail is dead padding with conf=0 and xyz parked far
outside any scene box so the voxel grid never indexes it. Only the forward
gather is ported here; its backward comes with training.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..config import PointsConfig

DEAD_XYZ = 1.0e8


class PointCloud(NamedTuple):
    xyz: torch.Tensor        # [N, 3]
    features: torch.Tensor   # [N, F]
    conf: torch.Tensor       # [N, 1]
    color: torch.Tensor      # [N, 3]
    dirs: torch.Tensor       # [N, 3]

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]


class PointCloudStatic(NamedTuple):
    num_active: torch.Tensor  # [] int32
    Rw2c: torch.Tensor        # [3, 3] global rotation


def round_capacity(n: int, multiple: int = 4096) -> int:
    """Bucket capacity so prune/grow re-allocate only on bucket change."""
    return max(multiple, -(-n // multiple) * multiple)


def make_point_cloud(xyz: np.ndarray, generator: Optional[torch.Generator],
                     cfg: PointsConfig, feature_dim: int,
                     features: Optional[np.ndarray] = None,
                     color: Optional[np.ndarray] = None,
                     dirs: Optional[np.ndarray] = None,
                     conf: Optional[np.ndarray] = None,
                     capacity: Optional[int] = None,
                     device: DeviceLike = None):
    """Build a padded PointCloud from raw numpy arrays.

    Features not given are drawn as `torch.rand(...) * 0.01` from
    `generator` (a CPU generator: the same seed gives the same cloud on every
    device), or zeros for `feature_init_method="zeros"`."""
    dev = resolve_device(device)
    n = xyz.shape[0]
    cap = capacity or round_capacity(n)

    def pad(a, fill=0.0):
        out = np.full((cap, a.shape[1]), fill, np.float32)
        out[:n] = a
        return torch.from_numpy(out).to(dev)

    if features is None:
        if cfg.feature_init_method == "zeros":
            features = np.zeros((n, feature_dim), np.float32)
        else:
            features = (torch.rand((n, feature_dim), generator=generator,
                                   dtype=torch.float32) * 0.01).numpy()
    if conf is None:
        conf = np.full((n, 1), cfg.default_conf, np.float32)
    if color is None:
        color = np.zeros((n, 3), np.float32)
    if dirs is None:
        dirs = np.zeros((n, 3), np.float32)
    pc = PointCloud(xyz=pad(xyz, DEAD_XYZ), features=pad(features),
                    conf=pad(conf), color=pad(color), dirs=pad(dirs))
    st = PointCloudStatic(
        num_active=torch.tensor(n, dtype=torch.int32, device=dev),
        Rw2c=torch.eye(3, dtype=torch.float32, device=dev))
    return pc, st


class SampledPoints(NamedTuple):
    """Per-(shading point, neighbor) gathered payloads."""
    xyz: torch.Tensor        # [..., K, 3]
    xyz_pers: torch.Tensor   # [..., K, 3]
    features: torch.Tensor   # [..., K, F]
    conf: torch.Tensor       # [..., K, 1]
    color: torch.Tensor      # [..., K, 3]
    dirs: torch.Tensor       # [..., K, 3]
    mask: torch.Tensor       # [..., K] bool


def gather_points(pc: PointCloud, xyz_pers: torch.Tensor,
                  sample_pidx: torch.Tensor) -> SampledPoints:
    """Gather neighbor payloads. xyz_pers [N, 3] are the perspective coords
    of all points for the current camera; sample_pidx [..., K] (-1 invalid;
    invalid rows gather point 0 and are masked downstream). All payloads
    ride one [N, 13+F] table, so this is one row gather."""
    mask = sample_pidx >= 0
    idx = sample_pidx.clamp(min=0).long()
    F = pc.features.shape[-1]
    table = torch.cat([pc.xyz, xyz_pers, pc.features, pc.conf, pc.color,
                       pc.dirs], dim=-1)
    rows = table[idx]                                  # [..., K, 13+F]
    splits = rows.split([3, 3, F, 1, 3, 3], dim=-1)
    return SampledPoints(*splits, mask=mask)
