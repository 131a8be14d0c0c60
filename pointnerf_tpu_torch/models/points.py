"""The neural point cloud: positions + per-point payloads as torch tensors.

Counterpart of `pointnerf_tpu/models/points.py` (`PointCloud`,
`PointCloudStatic`, `round_capacity`, `make_point_cloud`, `SampledPoints`,
`gather_points` with both `gather_bwd` backward modes, `prune`, `grow`).
The cloud is padded to a fixed capacity: `num_active` points are live, the
tail is dead padding with conf=0 and xyz parked far outside any scene box so
the voxel grid never indexes it. Prune and grow re-pack inside the same
capacity (`train/grow.py` re-buckets when growth needs more).
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
    # [3, 3] global rotation, or [cap, 3, 3] per point (editing composites)
    Rw2c: torch.Tensor


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


class _TableGatherSortBwd(torch.autograd.Function):
    """table[idx] whose backward is a sorted segment sum: the cotangent rows
    are argsorted by point id and summed per id in that order (the JAX
    `_table_gather_sortbwd`), deterministic on every device."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, ct):
        idx, = ctx.saved_tensors
        ids = idx.reshape(-1)
        ctf = ct.reshape(-1, ct.shape[-1])
        order = torch.argsort(ids, stable=True)
        lengths = torch.bincount(ids, minlength=ctx.n)
        g = torch.segment_reduce(ctf[order], "sum", lengths=lengths,
                                 unsafe=True)
        return g, None


def gather_points(pc: PointCloud, xyz_pers: torch.Tensor,
                  sample_pidx: torch.Tensor,
                  bwd: str = "scatter") -> SampledPoints:
    """Gather neighbor payloads. xyz_pers [N, 3] are the perspective coords
    of all points for the current camera; sample_pidx [..., K] (-1 invalid;
    invalid rows gather point 0 and are masked downstream). All payloads
    ride one [N, 13+F] table, so this is one row gather.

    bwd: QueryConfig.gather_bwd — "scatter" (autograd of the row gather, an
    index_add_ scatter-add) or "sort" (argsort + sorted segment sum,
    `_TableGatherSortBwd`). Both give the same gradient up to f32 summation
    order."""
    if bwd not in ("scatter", "sort"):
        raise ValueError(f"gather_bwd must be 'scatter' or 'sort', got {bwd!r}")
    mask = sample_pidx >= 0
    idx = sample_pidx.clamp(min=0).long()
    F = pc.features.shape[-1]
    table = torch.cat([pc.xyz, xyz_pers, pc.features, pc.conf, pc.color,
                       pc.dirs], dim=-1)
    if bwd == "sort" and table.requires_grad:
        rows = _TableGatherSortBwd.apply(table, idx)   # [..., K, 13+F]
    else:
        # index_select, not table[idx]: its backward is index_add_ (a
        # scatter-add), where advanced indexing's backward sorts the
        # duplicate ids and was ~110 ms a step at bench_config on an H100
        rows = table.index_select(0, idx.reshape(-1)).view(
            *idx.shape, table.shape[-1])
    splits = rows.split([3, 3, F, 1, 3, 3], dim=-1)
    return SampledPoints(*splits, mask=mask)


def prune(pc: PointCloud, st: PointCloudStatic, thresh: float,
          return_order: bool = False,
          protect: Optional[torch.Tensor] = None):
    """Drop points with conf <= thresh, packing the survivors to the front
    of the same capacity in their old order. Returns (pc, st, kept[,
    order]): `order` [capacity] is the stable survivors-first permutation,
    so callers can permute per-point optimizer moments along with the
    points. protect: optional [capacity] bool of live points exempt from
    the confidence test."""
    n = pc.capacity
    ar = torch.arange(n, device=pc.xyz.device)
    live = ar < st.num_active
    alive = live & (pc.conf[:, 0] > thresh)
    if protect is not None:
        alive = alive | (live & protect)
    order = torch.argsort((~alive).to(torch.int32), stable=True)
    kept = alive.to(torch.int32).sum().to(torch.int32)
    dead = (ar >= kept)[:, None]

    def pack(a, fill):
        return torch.where(dead, torch.full_like(a[:1], fill), a[order])

    pc2 = PointCloud(xyz=pack(pc.xyz, DEAD_XYZ),
                     features=pack(pc.features, 0.0),
                     conf=pack(pc.conf, 0.0), color=pack(pc.color, 0.0),
                     dirs=pack(pc.dirs, 0.0))
    st2 = st._replace(num_active=kept)
    return (pc2, st2, kept, order) if return_order else (pc2, st2, kept)


def grow(pc: PointCloud, st: PointCloudStatic, new_xyz, new_features,
         new_conf, new_color, new_dirs):
    """Append grown points into the padding tail. new_* are [M, ...] rows;
    rows whose x is DEAD_XYZ are ignored, and rows past the capacity are
    dropped (the caller re-buckets first when it needs them all). Returns
    (pc, st, added)."""
    n = pc.capacity
    new_ok = new_xyz[:, 0] < DEAD_XYZ / 2
    new_rank = torch.cumsum(new_ok.to(torch.int32), 0) - 1
    # row n is a sink for ignored and overflowing rows
    dst = torch.where(new_ok, st.num_active + new_rank, n).clamp(max=n).long()

    def app(a, na):
        out = torch.cat([a, a.new_zeros((1,) + a.shape[1:])])
        out[dst] = na.to(a.dtype)
        return out[:n]

    pc2 = PointCloud(xyz=app(pc.xyz, new_xyz),
                     features=app(pc.features, new_features),
                     conf=app(pc.conf, new_conf), color=app(pc.color, new_color),
                     dirs=app(pc.dirs, new_dirs))
    added = torch.minimum(new_ok.to(torch.int32).sum(),
                          n - st.num_active).to(torch.int32)
    return pc2, st._replace(num_active=st.num_active + added), added
