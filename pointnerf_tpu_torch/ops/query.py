"""Ray sampling, shading-point selection and the K-nearest-neighbor query.

Counterpart of `pointnerf_tpu/ops/query.py`: `near_far_linear_ray_generation`,
`select_shading_points`, `generate_shading_points`, `knn_query`, the
prebuilt-table branch of `_knn_chunk`, whose selection is kernel K1
(`ops/knn_select.py`), and the dense neighbor query `query_points`. Static shapes as in JAX: all R rays are kept and
`sample_mask` / `ray_mask` carry validity.

Integer outputs (which ray samples are shading slots, which points are
neighbors) must equal the JAX package's, so the float arithmetic that decides
them follows what the compiled JAX reference does on the CPU: linspace
multiplies by the reciprocal of the step count, and a*b+c is one rounding
(emulated here by computing in float64 and rounding once).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import not_ported
from ..config import QueryConfig
from .grid import GridMeta, PointGrid, flat_vid, grid_meta, voxel_coords
from .knn_select import knn_select


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """round(a*b + c) in float32 with one rounding of the product-sum."""
    return (a.double() * b.double() + c.double()).float()


def _linear_depths(D: int, near: float, far: float):
    """(segment lengths [D], segment midpoints [D]) of the un-jittered
    near_far_linear generator, float32 as the JAX package computes them."""
    f32 = np.float32
    t = np.arange(D + 1, dtype=f32) * (f32(1.0) / f32(D))
    t[-1] = f32(1.0)
    tvals = (np.float64(f32(near) * (f32(1.0) - t))
             + np.float64(f32(far)) * np.float64(t)).astype(f32)
    seg = tvals[1:] - tvals[:-1]
    end = np.concatenate([[f32(near)],
                          f32(near) + np.cumsum(seg, dtype=f32)]).astype(f32)
    return seg, (f32(0.5) * (end[:-1] + end[1:])).astype(f32)


def _xla_cumsum(x: torch.Tensor, base: int = 16) -> torch.Tensor:
    """Inclusive float32 cumsum along the last axis of x [R, N], summed in
    the order the compiled JAX package sums it on the CPU: XLA rewrites a
    long cumsum into blocks of `base` (summed in order inside a block), a
    cumsum of the block totals (the same way, recursively) and one add of
    the exclusive carry. The same adds on every device, so the card and the
    CPU agree bit for bit."""
    R, N = x.shape
    n = N if N <= base else -(-N // base) * base
    out = torch.zeros((R, n), dtype=x.dtype, device=x.device)
    out[:, :N] = x
    blocks = out.view(R, n // base, base) if N > base else out.view(R, 1, n)
    for j in range(1, blocks.shape[-1]):
        blocks[..., j] += blocks[..., j - 1]
    if N > base:
        carry = _xla_cumsum(blocks[..., -1], base)
        blocks[:, 1:] += carry[:, :-1, None]
    return out[:, :N]


def near_far_linear_ray_generation(campos, raydir, point_count: int, near,
                                   far, jitter: float = 0.0,
                                   generator: Optional[torch.Generator] = None,
                                   u: Optional[torch.Tensor] = None):
    """Uniform-in-depth midpoint samples. campos [3]; raydir [R, 3].
    Returns (raypos [R, D, 3], seglen [R, D], tvals [R, D]).

    With jitter > 0 and a uniform draw — `u` [R, D] in [0, 1) if given,
    else drawn from `generator` (on raydir's device) — every segment length
    is scaled by 1 + jitter * (u - 0.5) before the cumsum, as in JAX. Without
    a draw the samples are not jittered (JAX: no key)."""
    R, D = raydir.shape[0], point_count
    dev = raydir.device
    seg, mid = (torch.from_numpy(a).to(dev)
                for a in _linear_depths(D, float(near), float(far)))
    if jitter > 0.0 and (u is not None or generator is not None):
        if u is None:
            u = torch.rand((R, D), generator=generator, device=dev)
        # XLA contracts 1 + jitter * (u - 0.5) into one fused multiply-add
        j = torch.tensor(jitter, dtype=torch.float32, device=dev)
        seg = seg[None, :] * _fma(j, u.float() - 0.5, torch.ones((), device=dev))
        nearf = torch.tensor(float(near), dtype=torch.float32, device=dev)
        end = torch.cat([nearf.expand(R, 1), nearf + _xla_cumsum(seg)], -1)
        mid = 0.5 * (end[:, :-1] + end[:, 1:])
    else:
        seg, mid = seg[None, :].expand(R, D), mid[None, :].expand(R, D)
    raypos = _fma(raydir[:, None, :], mid[..., None], campos)
    seglen = seg * torch.linalg.norm(raydir, dim=-1, keepdim=True)
    return raypos, seglen, mid


RAY_GENERATORS = {"near_far_linear": near_far_linear_ray_generation}


def select_shading_points(raypos: torch.Tensor, grid: PointGrid,
                          meta: GridMeta, SR: int, tvals: torch.Tensor,
                          campos: torch.Tensor, raydir: torch.Tensor):
    """The first SR ray samples (in depth order) that land in dilated-occupied
    voxels. One occupancy gather and a cumsum rank per ray; the JAX package's
    three formulations ("merge", "sort", "scatter") give the same result.
    Returns (sample_loc_w [R, SR, 3], sample_mask [R, SR])."""
    R, D, _ = raypos.shape
    G = meta.num_cells
    vid, inb = flat_vid(voxel_coords(raypos, meta), meta)       # [R, D]
    occ = grid.vox_occ[vid.clamp(max=G - 1).long()]
    hit = inb & (occ > 0)
    rank = torch.cumsum(hit.to(torch.int32), 1) - 1
    dst = torch.where(hit & (rank < SR), rank, SR).long()
    d_ar = torch.arange(D, dtype=torch.int64, device=raypos.device)
    idx = torch.full((R, SR + 1), D, dtype=torch.int64, device=raypos.device)
    idx.scatter_(1, dst, d_ar.expand(R, D).contiguous())
    idx = idx[:, :SR]                     # column SR collected the misses
    sample_mask = idx < D
    t = torch.gather(tvals, 1, idx.clamp(max=D - 1))               # [R, SR]
    sample_loc_w = _fma(raydir[:, None, :], t[..., None], campos)
    sample_loc_w = torch.where(sample_mask[..., None], sample_loc_w, 0.0)
    return sample_loc_w, sample_mask


def _knn_chunk(centers, center_valid, grid: PointGrid, meta: GridMeta,
               cfg: QueryConfig):
    """Prebuilt-table KNN: each center reads its own cell's table row.
    Returns (pidx [C, K] int32 -1-padded, d2 [C, K])."""
    G1 = grid.vox_slot.shape[0] - 1
    cvid, cinb = flat_vid(voxel_coords(centers, meta), meta)
    dslot = torch.where(cinb, grid.vox_dslot[cvid.clamp(max=G1).long()], -1)
    ok = (dslot >= 0) & center_valid
    return knn_select(grid.nbr_xyz, grid.nbr_pid, dslot.to(torch.int32),
                      centers.contiguous(), ok.contiguous(), K=cfg.K,
                      r2=cfg.radius_limit ** 2)


def knn_query(sample_loc_w: torch.Tensor, sample_mask: torch.Tensor,
              xyz: torch.Tensor, grid: PointGrid, cfg: QueryConfig):
    """K nearest neural points for every shading point.
    sample_loc_w [..., 3]; sample_mask [...]. Returns (sample_pidx [..., K]
    int32, -1 invalid; d2 [..., K]). The whole batch is one kernel launch
    (`knn_chunk` only bounds workspace in the JAX package)."""
    if grid.nbr_xyz is None:
        raise not_ported("the KNN without prebuilt neighbor tables",
                         "Queue 1, query: bucket branch")
    if cfg.NN <= 0:
        raise not_ported("the NN=0 random-subset query",
                         "Queue 1, query: NN=0 branch")
    if cfg.shell_layered:
        raise not_ported("the shell-layered KNN", "Queue 1, query: "
                         "shell_layered branch")
    meta = grid_meta(cfg)
    lead = sample_mask.shape
    pidx, d2 = _knn_chunk(sample_loc_w.reshape(-1, 3),
                          sample_mask.reshape(-1), grid, meta, cfg)
    return pidx.reshape(lead + (cfg.K,)), d2.reshape(lead + (cfg.K,))


def generate_shading_points(grid: PointGrid, campos, raydir, near: float,
                            far: float, cfg: QueryConfig,
                            jitter: float = 0.0,
                            generator: Optional[torch.Generator] = None,
                            gen_name: Optional[str] = None,
                            gen_kwargs: Tuple = (),
                            u: Optional[torch.Tensor] = None):
    """Ray generation + occupancy-selected shading locations (the pre-KNN
    half of the query). `generator` / `u` feed the jitter (see
    `near_far_linear_ray_generation`). Returns (sample_loc_w [R,SR,3],
    sample_mask [R,SR])."""
    name = gen_name or ("near_far_disparity_linear" if cfg.inverse > 0
                        else "near_far_linear")
    if name not in RAY_GENERATORS or gen_kwargs:
        raise not_ported(f"ray generator {name!r}",
                         "Queue 1, query: other ray generators")
    raypos, _seg, tvals = RAY_GENERATORS[name](
        campos, raydir, cfg.z_depth_dim, near, far, jitter=jitter,
        generator=generator, u=u)
    return select_shading_points(raypos, grid, grid_meta(cfg), cfg.SR,
                                 tvals, campos, raydir)


class QueryResult(NamedTuple):
    sample_pidx: torch.Tensor    # [R, SR, K] int32, -1 invalid
    sample_loc_w: torch.Tensor   # [R, SR, 3] world shading locations
    sample_mask: torch.Tensor    # [R, SR] bool: the slot has a neighbor
    ray_mask: torch.Tensor       # [R] bool: the ray has >= 1 neighbor


def query_points(xyz: torch.Tensor, grid: PointGrid, campos, raydir,
                 near: float, far: float, cfg: QueryConfig,
                 jitter: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 gen_name: Optional[str] = None, gen_kwargs: Tuple = (),
                 u: Optional[torch.Tensor] = None) -> QueryResult:
    """The dense neighbor query: shading points, their K nearest neural
    points on every [R, SR] slot, and the post-KNN masks (slots and rays
    whose query found no neighbor drop out)."""
    sample_loc_w, sample_mask = generate_shading_points(
        grid, campos, raydir, near, far, cfg, jitter=jitter,
        generator=generator, gen_name=gen_name, gen_kwargs=gen_kwargs, u=u)
    sample_pidx, _d2 = knn_query(sample_loc_w, sample_mask, xyz, grid, cfg)
    pnt_mask = sample_pidx >= 0
    ray_mask = pnt_mask.reshape(raydir.shape[0], -1).any(-1)
    return QueryResult(sample_pidx=sample_pidx, sample_loc_w=sample_loc_w,
                       sample_mask=sample_mask & pnt_mask.any(-1),
                       ray_mask=ray_mask)
