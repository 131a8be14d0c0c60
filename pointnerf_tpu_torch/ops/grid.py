"""Occupancy voxel grid over the neural point cloud, with the prebuilt
neighbor tables the KNN kernel reads.

Counterpart of `pointnerf_tpu/ops/grid.py` (`GridMeta`, `grid_meta`,
`voxel_coords`, `flat_vid`, `kernel_offsets_layered`, `build_grid`). The
tables are built with the same deterministic rules, so they equal the JAX
ones entry for entry:

  vox_slot   [G]         flat scaled-voxel id -> occupied-voxel slot (or -1)
  vox_occ    [G] int8    occupancy dilated by `query_size`
  bucket_pnt [max_o, P]  point ids per occupied voxel, ascending (-1 pad)
  vox_dslot  [G]         cell -> dilated-occupied slot (or -1)
  nbr_xyz    [max_d, 3*Q*P] candidate coordinates, coordinate-major rows
                         ([3][Q*P]; dead slots 1e8)
  nbr_pid    [max_d, Q*P]   candidate point ids (-1 pad)
  occ_vids   [max_dv]    sorted dilated-occupied cell ids (G pad)
  num_dil    []          true dilated-occupied cell count before the cap

Candidate lane order inside a row is the layered kernel-offset order
(`kernel_offsets_layered`) times the bucket order (points sorted stably by
voxel id, so ascending point id): the KNN's tie-break on the lowest lane
depends on both.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import QueryConfig

DEAD = 1.0e8


class GridMeta(NamedTuple):
    lo: Tuple[float, float, float]
    vdim: Tuple[int, int, int]
    scaled_vsize: Tuple[float, float, float]

    @property
    def num_cells(self) -> int:
        return self.vdim[0] * self.vdim[1] * self.vdim[2]


class PointGrid(NamedTuple):
    vox_slot: torch.Tensor     # [G] int32
    vox_occ: torch.Tensor      # [G] int8
    bucket_pnt: torch.Tensor   # [max_o, P] int32
    bucket_cnt: torch.Tensor   # [max_o] int32
    num_occ: torch.Tensor      # [] int32
    bucket_xyz: torch.Tensor   # [max_o, P, 3] float32
    vox_dslot: Optional[torch.Tensor] = None  # [G] int32
    num_dil: Optional[torch.Tensor] = None    # [] int32
    nbr_xyz: Optional[torch.Tensor] = None    # [max_d, 3*Q*P] float32
    nbr_pid: Optional[torch.Tensor] = None    # [max_d, Q*P] int32
    occ_vids: Optional[torch.Tensor] = None   # [max_dv] int32


def grid_meta(cfg: QueryConfig) -> GridMeta:
    lo, _hi, vdim = cfg.grid_bounds()
    return GridMeta(lo=lo, vdim=vdim, scaled_vsize=cfg.scaled_vsize)


def voxel_coords(xyz: torch.Tensor, meta: GridMeta) -> torch.Tensor:
    """World position [..., 3] -> integer scaled-voxel coords [..., 3].

    floor((x - lo) * (1 / vsize)) in float32, with the reciprocal rounded to
    float32 first: the compiled JAX reference multiplies by the reciprocal
    rather than dividing, and a point on a voxel face must land in the same
    cell in both packages. Far-away coordinates are clamped before the
    integer cast (they stay out of bounds)."""
    lo = torch.tensor(meta.lo, dtype=torch.float32, device=xyz.device)
    inv = torch.from_numpy(
        np.float32(1.0) / np.asarray(meta.scaled_vsize, np.float32)
    ).to(xyz.device)
    c = torch.floor((xyz - lo) * inv)
    return c.clamp(-1.0, float(1 << 30)).to(torch.int32)


def flat_vid(coor: torch.Tensor, meta: GridMeta):
    """Integer coords -> (flat voxel id, in-bounds mask). Out of bounds -> G."""
    gx, gy, gz = meta.vdim
    vdim = torch.tensor(meta.vdim, dtype=torch.int32, device=coor.device)
    inb = torch.all((coor >= 0) & (coor < vdim), dim=-1)
    vid = coor[..., 0] * (gy * gz) + coor[..., 1] * gz + coor[..., 2]
    return torch.where(inb, vid, meta.num_cells), inb


def _dilation_offsets(query_size) -> np.ndarray:
    """Per-axis reach [-(k//2), (k+1)//2 - 1], x-major."""
    axes = [np.arange(-(int(k) // 2), (int(k) + 1) // 2) for k in query_size]
    ox, oy, oz = np.meshgrid(*axes, indexing="ij")
    return np.stack([ox.ravel(), oy.ravel(), oz.ravel()], -1).astype(np.int32)


def kernel_offsets_layered(kernel_size) -> Tuple[np.ndarray, np.ndarray]:
    """Neighbor-voxel offsets ordered (stably) by shell layer
    max(|x|,|y|,|z|). The neighbor-table lane order follows it."""
    offs = _dilation_offsets(kernel_size)
    layer = np.abs(offs).max(axis=-1)
    order = np.argsort(layer, kind="stable")
    return offs[order], layer[order]


def _set_drop(size: int, fill, dtype, idx: torch.Tensor, val: torch.Tensor):
    """out[idx] = val into a [size] (or [size, ...]) buffer where idx == size
    means "drop" (the scatter's mode="drop" in the JAX build)."""
    shape = (size + 1,) + tuple(val.shape[1:])
    out = torch.full(shape, fill, dtype=dtype, device=val.device)
    out[idx.long()] = val.to(dtype)
    return out[:size]


def build_grid(xyz: torch.Tensor, num_active: torch.Tensor,
               cfg: QueryConfig) -> PointGrid:
    """Build the occupancy grid (and, with `prebuild_neighbors`, the
    neighbor tables) from point positions. xyz [N, 3] float32, padded;
    entries >= num_active are ignored."""
    meta = grid_meta(cfg)
    dev = xyz.device
    N = xyz.shape[0]
    G = meta.num_cells
    max_o, P = cfg.max_o, cfg.P
    i32 = torch.int32
    gy, gz = meta.vdim[1], meta.vdim[2]

    vid, inb = flat_vid(voxel_coords(xyz, meta), meta)
    alive = torch.arange(N, device=dev) < num_active
    vid = torch.where(alive & inb, vid, G).to(i32)

    # stable sort by voxel id: ties keep ascending point id
    sorted_vid, sorted_pid = torch.sort(vid, stable=True)
    sorted_pid = sorted_pid.to(i32)
    valid = sorted_vid < G
    prev = torch.cat([torch.full((1,), -1, dtype=i32, device=dev),
                      sorted_vid[:-1]])
    is_new = (sorted_vid != prev) & valid
    occ_rank = (torch.cumsum(is_new.to(i32), 0) - 1).to(i32)
    num_occ = (occ_rank[-1] + 1) if N > 0 else torch.zeros((), dtype=i32)

    idx = torch.arange(N, dtype=i32, device=dev)
    seg_start = torch.cummax(torch.where(is_new, idx, -1), 0).values
    within = idx - seg_start
    occ_ok = valid & (occ_rank >= 0) & (occ_rank < max_o)

    row = torch.where(occ_ok & (within < P), occ_rank, max_o).long()
    col = torch.where(within < P, within, 0).long()
    bucket_pnt = torch.full((max_o + 1, P), -1, dtype=i32, device=dev)
    bucket_pnt[row, col] = sorted_pid
    bucket_pnt = bucket_pnt[:max_o]
    cnt_idx = torch.where(occ_ok, occ_rank, max_o).long()
    bucket_cnt = torch.zeros(max_o + 1, dtype=i32, device=dev).index_add_(
        0, cnt_idx, torch.ones(N, dtype=i32, device=dev))[:max_o]
    bucket_cnt = bucket_cnt.clamp(max=P)

    head = is_new & occ_ok
    vox_slot = _set_drop(G, -1, i32, torch.where(head, sorted_vid, G),
                         occ_rank)
    occ_vid = _set_drop(max_o, G, i32, torch.where(head, occ_rank, max_o),
                        sorted_vid)
    occ_c = torch.stack([occ_vid // (gy * gz), (occ_vid // gz) % gy,
                         occ_vid % gz], -1)
    occ_valid = occ_vid < G

    offs = torch.from_numpy(_dilation_offsets(cfg.query_size)).to(dev)
    nvid, ninb = flat_vid(occ_c[:, None, :] + offs[None], meta)
    nvid = torch.where(ninb & occ_valid[:, None], nvid, G).to(i32)
    flat_n = nvid.reshape(-1)
    vox_occ = _set_drop(G, 0, torch.int8, flat_n,
                        torch.ones_like(flat_n, dtype=torch.int8))

    bucket_xyz = torch.where((bucket_pnt >= 0)[..., None],
                             xyz[bucket_pnt.clamp(min=0).long()],
                             torch.tensor(DEAD, device=dev))

    # deduplicated sorted dilated-occupied cell list; the prebuilt tables
    # get one row per listed cell (up to max_d)
    Qd = offs.shape[0]
    max_d = cfg.max_d or 4 * max_o
    max_dv = cfg.max_d or min(G, max_o * Qd)
    dil = torch.sort(flat_n).values
    d_new = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       dil[1:] != dil[:-1]]) & (dil < G)
    drank = (torch.cumsum(d_new.to(i32), 0) - 1).to(i32)
    dv_ok = d_new & (drank >= 0) & (drank < max_dv)
    occ_vids = _set_drop(max_dv, G, i32, torch.where(dv_ok, drank, max_dv),
                         dil)
    d_ok = d_new & (drank >= 0) & (drank < max_d)
    dil_vid = _set_drop(max_d, G, i32, torch.where(d_ok, drank, max_d), dil)
    num_dil = d_new.to(i32).sum().to(i32)

    vox_dslot = nbr_xyz = nbr_pid = None
    if cfg.prebuild_neighbors:
        assert all(q >= k for q, k in zip(cfg.query_size, cfg.kernel_size)), \
            "prebuild_neighbors requires query_size >= kernel_size"
        vox_dslot = _set_drop(G, -1, i32, torch.where(d_ok, dil, G), drank)
        dcoor = torch.stack([dil_vid // (gy * gz), (dil_vid // gz) % gy,
                             dil_vid % gz], -1)
        koffs, _ = kernel_offsets_layered(cfg.kernel_size)
        koffs = torch.from_numpy(koffs).to(dev)
        kn, kinb = flat_vid(dcoor[:, None, :] + koffs[None], meta)
        kslot = torch.where(kinb & (dil_vid < G)[:, None],
                            vox_slot[kn.clamp(max=G - 1).long()], -1)
        ksc = kslot.clamp(min=0).long()
        live = kslot >= 0
        g3 = torch.where(live[..., None, None], bucket_xyz[ksc],
                         torch.tensor(DEAD, device=dev)).reshape(max_d, -1, 3)
        # coordinate-major flat rows: [x(Q*P) | y(Q*P) | z(Q*P)]
        nbr_xyz = g3.permute(0, 2, 1).reshape(max_d, -1).contiguous()
        nbr_pid = torch.where(live[..., None], bucket_pnt[ksc], -1
                              ).reshape(max_d, -1).to(i32).contiguous()

    return PointGrid(vox_slot=vox_slot, vox_occ=vox_occ,
                     bucket_pnt=bucket_pnt, bucket_cnt=bucket_cnt,
                     num_occ=num_occ.to(i32), bucket_xyz=bucket_xyz,
                     vox_dslot=vox_dslot, num_dil=num_dil, nbr_xyz=nbr_xyz,
                     nbr_pid=nbr_pid, occ_vids=occ_vids)
