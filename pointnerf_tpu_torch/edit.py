"""Scene composition / editing: merge several scenes' neural point clouds
with per-part rigid transforms and render the composite.

Counterpart of `pointnerf_tpu/edit.py` (`ScenePart`, `compose_parts`):
each part contributes its points (optionally cropped by an AABB),
transformed by (R, t); the part's rotation is also recorded per point as
Rw2c = Rᵀ, so the shading MLPs, trained in each part's original frame, keep
seeing local-frame distances and view directions (the aggregator's
per-neighbor rotation path, which feeds K3 and K4 unchanged).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import DeviceLike, resolve_device
from .models.points import (DEAD_XYZ, PointCloud, PointCloudStatic,
                            round_capacity)


@dataclass
class ScenePart:
    """One editable part: a point cloud, its payloads and a rigid
    transform (numpy arrays)."""
    xyz: np.ndarray                  # [N, 3] in the part's original frame
    features: np.ndarray             # [N, F]
    conf: np.ndarray                 # [N, 1]
    color: np.ndarray                # [N, 3]
    dirs: np.ndarray                 # [N, 3]
    R: np.ndarray = field(default_factory=lambda: np.eye(3, dtype=np.float32))
    t: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    crop_aabb: Optional[Tuple[float, ...]] = None  # (x0,y0,z0,x1,y1,z1)

    def transformed(self):
        """Returns (xyz_world, dirs_world, keep_mask)."""
        keep = np.ones(self.xyz.shape[0], bool)
        if self.crop_aabb is not None:
            lo = np.asarray(self.crop_aabb[:3], np.float32)
            hi = np.asarray(self.crop_aabb[3:], np.float32)
            keep = np.all((self.xyz >= lo) & (self.xyz <= hi), axis=-1)
        xyz_w = self.xyz @ self.R.T + self.t
        dirs_w = self.dirs @ self.R.T
        return xyz_w, dirs_w, keep


def compose_parts(parts: List[ScenePart], device: DeviceLike = None):
    """Merge parts into one cloud padded to `round_capacity` (dead rows at
    DEAD_XYZ) with per-point Rw2c = Rᵀ of each point's part (identity on
    the padding). Returns (PointCloud, PointCloudStatic with Rw2c
    [cap, 3, 3]) on `device`."""
    dev = resolve_device(device)
    xs, fs, cs, cols, ds, rs = [], [], [], [], [], []
    for part in parts:
        xyz_w, dirs_w, keep = part.transformed()
        xs.append(xyz_w[keep])
        fs.append(part.features[keep])
        cs.append(part.conf[keep])
        cols.append(part.color[keep])
        ds.append(dirs_w[keep])
        rs.append(np.broadcast_to(part.R.T[None], (keep.sum(), 3, 3)))
    xyz = np.concatenate(xs).astype(np.float32)
    n = xyz.shape[0]
    cap = round_capacity(n)

    def pad(a, fill=0.0):
        out = np.full((cap,) + a.shape[1:], fill, np.float32)
        out[:n] = a
        return torch.from_numpy(out).to(dev)

    pc = PointCloud(
        xyz=pad(xyz, DEAD_XYZ), features=pad(np.concatenate(fs)),
        conf=pad(np.concatenate(cs)), color=pad(np.concatenate(cols)),
        dirs=pad(np.concatenate(ds)))
    Rw2c = np.tile(np.eye(3, dtype=np.float32), (cap, 1, 1))
    Rw2c[:n] = np.concatenate(rs)
    st = PointCloudStatic(
        num_active=torch.tensor(n, dtype=torch.int32, device=dev),
        Rw2c=torch.from_numpy(Rw2c).to(dev))
    return pc, st
