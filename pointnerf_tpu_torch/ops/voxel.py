"""Voxel downsampling of an init cloud.

Counterpart of `pointnerf_tpu/ops/voxel.py` (`voxelize_ids`,
`construct_vox_points_closest`): the cloud is voxelized at vox_res^3 over
its AABB and each occupied voxel keeps the point closest to the voxel's
centroid. One stable sort by voxel id and segment reductions, in torch on
the given device; the same arithmetic as the JAX package's (the centroid
sums in float64 in sorted order, the squared distances in float32, the
first point on a tie), so the kept ids are the same.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device


def voxelize_ids(xyz: torch.Tensor, vox_res: int):
    """Flat voxel id per point at vox_res^3 over the cloud's AABB (cell =
    span / vox_res). Returns (vid [N] int64, mn [3], cell [3])."""
    mn = xyz.amin(0)
    mx = xyz.amax(0)
    span = torch.clamp(mx - mn, min=1e-9)
    cell = span / vox_res
    c = torch.floor((xyz - mn) / cell).to(torch.int32).clamp(0, vox_res - 1)
    c = c.long()
    return (c[:, 0] * vox_res + c[:, 1]) * vox_res + c[:, 2], mn, cell


def construct_vox_points_closest(xyz, vox_res: int,
                                 device: DeviceLike = None
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """One representative point per occupied voxel, the one nearest the
    voxel's centroid. xyz [N, 3] (numpy or tensor). Returns (indices into
    xyz [M] int64, centroids [M, 3] float32), numpy, in ascending voxel
    id order."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(xyz, np.float32) if not torch.is_tensor(
        xyz) else xyz, dtype=torch.float32).to(dev)
    vid, _mn, _cell = voxelize_ids(x, vox_res)
    sv, order = torch.sort(vid, stable=True)
    new = torch.ones_like(sv, dtype=torch.bool)
    new[1:] = sv[1:] != sv[:-1]
    seg = torch.cumsum(new.long(), 0) - 1
    m = int(seg[-1]) + 1
    pts = x[order]
    sums = torch.zeros((m, 3), dtype=torch.float64, device=dev).index_add_(
        0, seg, pts.double())
    counts = torch.zeros(m, dtype=torch.float64, device=dev).index_add_(
        0, seg, torch.ones_like(seg, dtype=torch.float64))
    centroids = (sums / counts[:, None]).float()
    d = pts - centroids[seg]
    d = d * d
    d2 = d[:, 0] + d[:, 1] + d[:, 2]
    # per segment the smallest d2, the first in sorted order on a tie
    by_d2 = torch.sort(d2, stable=True).indices
    rank = by_d2[torch.sort(seg[by_d2], stable=True).indices]
    first = torch.ones_like(new)
    first[1:] = seg[rank][1:] != seg[rank][:-1]
    rep = order[rank[first]]
    return rep.cpu().numpy().astype(np.int64), centroids.cpu().numpy()
