"""The Point-NeRF forward pipeline: query -> gather -> aggregate -> march.

Counterpart of `pointnerf_tpu/models/renderer.py`: `RayBatch`,
`RenderOutput`, `compute_ray_dist`, `_finalize`, `shade` (the dense decode,
with the prob-mode probe outputs), `decode_slots`, `compact_select`,
`expand_compact_many`, `conf_coeff_fill`, `decode_compacted`,
`shade_compacted`, `_shade_at` and `render_rays` — the coarse render, with
the static-capacity compacted decode or the dense one (decode_capacity=0,
and every prob-mode probe), for inference and for training (jittered
samples, gradients). The kernels of this path: K1 (KNN select) inside
`knn_query`, K3 (fused decode) and its backward K4 inside `aggregate`, K2
(fused march) inside `_finalize` when not training; on the card they run
wherever they compute the function, whatever the fused flags say
(`aggregator.decode_takes_kernel`, `march_takes_kernel`).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import DeviceLike, not_ported, resolve_device
from ..camera import w2pers
from ..config import (PointNeRFConfig, effective_ray_generator,
                      generator_kwargs)
from ..ops.fused_march import MAX_C, fused_march
from ..ops.grid import PointGrid
from ..ops.query import generate_shading_points, knn_query, query_points
from .aggregator import aggregate, decode_takes_kernel
from .points import PointCloud, PointCloudStatic, gather_points
from .ray_march import (BLEND_FUNCS, RENDER_FUNCS, TONEMAP_FUNCS,
                        exclusive_transmission, ray_march)


class RayBatch(NamedTuple):
    campos: torch.Tensor      # [3]
    camrotc2w: torch.Tensor   # [3, 3]
    raydir: torch.Tensor      # [R, 3]
    pixel_idx: torch.Tensor   # [R, 2] int32
    near: torch.Tensor        # []
    far: torch.Tensor         # []
    gt_image: Optional[torch.Tensor] = None  # [R, 3]


class RenderOutput(NamedTuple):
    coarse_raycolor: torch.Tensor        # [R, C]
    coarse_is_background: torch.Tensor   # [R, 1]
    coarse_depth: torch.Tensor           # [R, 1]
    coarse_point_opacity: torch.Tensor   # [R, SR]
    queried_shading: torch.Tensor        # [R, 1]
    ray_mask: torch.Tensor               # [R] bool
    weight: torch.Tensor                 # [R, SR, K]
    conf_coefficient: torch.Tensor       # [R, SR, K]
    ray_valid: torch.Tensor              # [R, SR] bool
    sample_loc_w: torch.Tensor           # [R, SR, 3]
    decode_dropped: Optional[torch.Tensor] = None   # [] int32, compacted
    # neighbor ids of the decode: [C, K] compacted, [R, SR, K] dense
    neighbor_pidx: Optional[torch.Tensor] = None
    # prob-mode probe outputs (point growing), at each ray's sample of
    # largest opacity
    ray_max_shading_opacity: Optional[torch.Tensor] = None  # [R, 1]
    ray_max_sample_loc_w: Optional[torch.Tensor] = None     # [R, 3]
    ray_max_far_dist: Optional[torch.Tensor] = None         # [R, 1]
    shading_avg_color: Optional[torch.Tensor] = None        # [R, 3]
    shading_avg_dir: Optional[torch.Tensor] = None          # [R, 3]
    shading_avg_conf: Optional[torch.Tensor] = None         # [R, 1]
    shading_avg_embedding: Optional[torch.Tensor] = None    # [R, F]


def ray_batch_from_numpy(item: Dict, cfg: PointNeRFConfig,
                         device: DeviceLike = None) -> RayBatch:
    """A RayBatch on `device` from a `data.synthetic.view_ray_batch` item."""
    dev = resolve_device(device)

    def t(a, dt=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dt, device=dev)
    gt = item.get("gt_image")
    return RayBatch(campos=t(item["campos"]), camrotc2w=t(item["camrotc2w"]),
                    raydir=t(item["raydir"]),
                    pixel_idx=t(item["pixel_idx"], torch.int32),
                    near=t(cfg.render.near_plane), far=t(cfg.render.far_plane),
                    gt_image=None if gt is None else t(gt))


def march_takes_kernel(cfg: PointNeRFConfig, device: torch.device,
                       train: bool) -> bool:
    """Whether the compositor is K2 (its plain version on the CPU).
    Training takes the plain march under autograd, as the JAX package does.
    On the CPU the flag decides, as in JAX; on CUDA serving takes K2
    whenever it computes the march (radiance render, alpha blend), whatever
    `render.fused_march` says — the card never runs a kernel's plain twin.
    Such a render with more than `MAX_C` channels raises on CUDA, whatever
    the flag."""
    if train:
        return False
    r = cfg.render
    kernel_func = (r.which_render_func == "radiance"
                   and r.which_blend_func == "alpha")
    if r.fused_march and not kernel_func:
        raise ValueError(
            "render.fused_march supports only which_render_func="
            "'radiance' + which_blend_func='alpha'; got "
            f"{r.which_render_func!r}/{r.which_blend_func!r}")
    if device.type != "cuda":
        return r.fused_march
    if kernel_func and cfg.agg.shading_color_channel_num > MAX_C:
        raise not_ported(f"the fused march at C="
                         f"{cfg.agg.shading_color_channel_num}",
                         "Queue 2, K2 at C > 8")
    return kernel_func


def check_envelope(cfg: PointNeRFConfig, device: torch.device,
                   train: bool = False) -> None:
    """Raise for what the port does not implement yet, before any work: the
    fine pass and the hybrid, and on CUDA a config inside the fused
    envelope but past the port kernels' limits (`decode_takes_kernel`,
    `march_takes_kernel`)."""
    if cfg.render.fine_sample_num > 0:
        raise not_ported("the fine pass", "Queue 1, fine pass and hybrid")
    if cfg.render.nerf_importance > 0:
        raise not_ported("the proposal-NeRF hybrid",
                         "Queue 1, fine pass and hybrid")
    decode_takes_kernel(cfg.agg, cfg.query.K,
                        cfg.train.compute_dtype == "bf16", device,
                        backward=train)
    march_takes_kernel(cfg, device, train)


def compute_ray_dist(sample_loc_pers, ray_valid, vsize_z: float,
                     raydist_mode_unit: int):
    """Per-sample integration step from the cummax of perspective depth."""
    z = sample_loc_pers[..., 2]
    zmax = torch.cummax(z, dim=-1).values
    ray_dist = torch.cat([zmax[..., 1:] - zmax[..., :-1],
                          torch.full_like(zmax[..., :1], vsize_z)], -1)
    bad = ray_dist < 1e-8
    if raydist_mode_unit > 0:
        bad = bad | (ray_dist > 2 * vsize_z)
    ray_dist = torch.where(bad, torch.full_like(ray_dist, vsize_z), ray_dist)
    return ray_dist * ray_valid.to(ray_dist.dtype)


def _finalize(cfg: PointNeRFConfig, features, ray_valid, weight, conf_coeff,
              sample_loc, sample_loc_w, ray_mask, decode_dropped=None,
              train: bool = False) -> RenderOutput:
    """March + tonemap + output assembly over per-(ray, sample) decoded
    features [R, SR, 1+C]."""
    ray_dist = compute_ray_dist(sample_loc, ray_valid, cfg.query.vsize[2],
                                cfg.render.raydist_mode_unit)
    tonemap = TONEMAP_FUNCS[cfg.render.which_tonemap_func]
    dev = features.device
    bg = torch.tensor(cfg.render.bg_color, dtype=torch.float32, device=dev)
    if cfg.agg.shading_color_channel_num != 3:
        bg = torch.zeros(cfg.agg.shading_color_channel_num, device=dev)
    # Training takes the plain march, as the JAX package does
    # (renderer.py `_finalize`): K2 has no backward kernel there, its
    # custom VJP recomputes through the plain march, so under a gradient the
    # kernel would be pure overhead. The plain march runs under autograd on
    # the card.
    if march_takes_kernel(cfg, dev, train):
        # kernel K2; the blend weights for the depth are recomputed from its
        # opacity
        ray_color, opacity, background_transmission = fused_march(
            ray_dist.contiguous(), ray_valid.contiguous(),
            features.contiguous(), bg)
        blend_w = (opacity * exclusive_transmission(opacity))[..., None]
    else:
        (ray_color, _pc, opacity, _acc, blend_w, background_transmission,
         _bgw) = ray_march(ray_dist, ray_valid, features,
                           RENDER_FUNCS[cfg.render.which_render_func],
                           BLEND_FUNCS[cfg.render.which_blend_func], bg)
    ray_color = tonemap(ray_color)
    depth = torch.sum(blend_w[..., 0] * sample_loc[..., 2], -1, keepdim=True)
    queried_shading = (~ray_valid.any(-1, keepdim=True)).float()
    return RenderOutput(
        coarse_raycolor=ray_color, coarse_is_background=background_transmission,
        coarse_depth=depth, coarse_point_opacity=opacity,
        queried_shading=queried_shading, ray_mask=ray_mask, weight=weight,
        conf_coefficient=conf_coeff, ray_valid=ray_valid,
        sample_loc_w=sample_loc_w, decode_dropped=decode_dropped)


def shade(params: Dict, cfg: PointNeRFConfig, sp, sample_loc, sample_loc_w,
          sample_ray_dirs, Rw2c, prob: bool = False,
          compute_dtype=torch.float32, train: bool = False) -> RenderOutput:
    """The dense decode: aggregate every [R, SR, K] neighbor lane, march,
    tonemap. With `prob`, also the probe outputs of point growing at each
    ray's sample of largest opacity (the first one on a tie): its location,
    opacity, the distance to its nearest neighbor and the weight-averaged
    neighbor payloads."""
    compute_dtype = _compute_dtype(cfg, compute_dtype)
    agg = aggregate(params, cfg.agg, sp, sample_loc, sample_loc_w,
                    sample_ray_dirs, cfg.query.vsize, Rw2c=Rw2c,
                    compute_dtype=compute_dtype)
    ray_mask = sp.mask.reshape(sp.mask.shape[0], -1).any(-1)
    out = _finalize(cfg, agg.features, agg.ray_valid, agg.weight,
                    agg.conf_coefficient, sample_loc, sample_loc_w, ray_mask,
                    train=train)
    if not prob:
        return out
    op = out.coarse_point_opacity                              # [R, SR]
    max_op = op.amax(-1, keepdim=True)
    op_ind = op.argmax(-1)                       # the first maximum
    r = torch.arange(op.shape[0], device=op.device)
    loc_w = sample_loc_w[r, op_ind]                            # [R, 3]
    wk = (agg.weight * agg.conf_coefficient)[r, op_ind][..., None]
    dist = torch.linalg.norm(sp.xyz[r, op_ind] - loc_w[:, None, :], dim=-1)
    far = torch.where(sp.mask[r, op_ind], dist,
                      torch.full_like(dist, float("inf"))).amin(
                          -1, keepdim=True)
    far = torch.where(torch.isfinite(far), far, torch.zeros_like(far))
    return out._replace(
        ray_max_shading_opacity=max_op, ray_max_sample_loc_w=loc_w,
        ray_max_far_dist=far,
        shading_avg_color=(sp.color[r, op_ind] * wk).sum(-2),
        shading_avg_dir=(sp.dirs[r, op_ind] * wk).sum(-2),
        shading_avg_conf=(sp.conf[r, op_ind] * wk).sum(-2),
        shading_avg_embedding=(sp.features[r, op_ind] * wk).sum(-2))


def decode_slots(cfg: PointNeRFConfig, rs: int) -> int:
    """Static compact-decode capacity for `rs` dense sample slots (rounded
    up to 512, clamped to the dense extent)."""
    c = int(round(cfg.query.decode_capacity * rs))
    return min(rs, max(512, -(-c // 512) * 512))


def compact_select(v: torch.Tensor, C: int):
    """Stable valid-first compaction bookkeeping for a flat mask v [RS].
    Returns (keep [C] — flat index of the j-th valid slot, then the first
    non-selected slots; rank [RS]; sel [RS] valid and within capacity;
    cvalid [C]; n_valid [])."""
    RS = v.shape[0]
    d_ar = torch.arange(RS, device=v.device)
    rank = torch.cumsum(v.to(torch.int64), 0) - 1
    n_valid = v.to(torch.int32).sum().to(torch.int32)
    sel = v & (rank < C)
    key = torch.where(sel, rank, RS + d_ar)        # unique keys
    keep = torch.argsort(key)[:C]
    cvalid = torch.arange(C, device=v.device) < torch.clamp(n_valid, max=C)
    return keep, rank, sel, cvalid, n_valid


def expand_compact_many(arrs_fills, keep, cvalid, R: int, SR: int):
    """Scatter several compact [C, ...] tensors back to the dense [R, SR]
    frame in one packed row copy; slots not selected get their fill."""
    RS = R * SR
    dev = keep.device
    cols, fills, shapes, dtypes = [], [], [], []
    for a_c, fill in arrs_fills:
        a = a_c[:, 0] if a_c.dim() > 1 and a_c.shape[1] == 1 else a_c
        shapes.append(tuple(a.shape[1:]))
        dtypes.append(a.dtype)
        w = int(np.prod(a.shape[1:], dtype=np.int64)) if a.dim() > 1 else 1
        cols.append(a.reshape(a.shape[0], w).float())
        fills.append(torch.as_tensor(fill, dtype=torch.float32,
                                     device=dev).reshape(1).expand(w))
    packed = torch.cat(cols, -1)
    full = torch.cat(fills)[None, :].expand(RS + 1, -1).clone()
    dst = torch.where(cvalid, keep, RS)            # row RS takes the misses
    full.index_copy_(0, dst, packed)
    full = full[:RS]
    outs, off = [], 0
    for shp, dt in zip(shapes, dtypes):
        w = int(np.prod(shp, dtype=np.int64)) if shp else 1
        piece = full[:, off:off + w].reshape((R, SR) + shp)
        outs.append(piece > 0.5 if dt == torch.bool else piece.to(dt))
        off += w
    return outs


def conf_coeff_fill(cfg: PointNeRFConfig, pc: PointCloud):
    """conf_coefficient fill for slots without a decode: clamp(conf[0])."""
    return (pc.conf[0, 0].clamp(0.0001, 1.0) if cfg.agg.point_conf_mode
            else 1.0)


def decode_compacted(params: Dict, cfg: PointNeRFConfig, sp, cloc, cloc_w,
                     craydir, Rw2c, compute_dtype):
    """Aggregate a compact [C, 1, K] neighbor batch."""
    return aggregate(params, cfg.agg, sp, cloc[:, None], cloc_w[:, None],
                     craydir[:, None], cfg.query.vsize, Rw2c=Rw2c,
                     compute_dtype=compute_dtype)


def _compute_dtype(cfg: PointNeRFConfig, default=torch.float32):
    return torch.bfloat16 if cfg.train.compute_dtype == "bf16" else default


def shade_compacted(params: Dict, cfg: PointNeRFConfig, pc: PointCloud,
                    grid: PointGrid, sample_loc_w, sample_mask,
                    batch: RayBatch, Rw2c, compute_dtype=torch.float32,
                    train: bool = False) -> RenderOutput:
    """Static-capacity compacted KNN + decode: the first C valid slots (in
    ray-major order) are KNN-queried and decoded as a [C, 1, K] batch, and
    the results scattered back into the dense [R, SR] frame. Valid slots
    beyond C render as background and are counted in `decode_dropped`."""
    compute_dtype = _compute_dtype(cfg, compute_dtype)
    R, SR = sample_mask.shape
    RS = R * SR
    C = decode_slots(cfg, RS)
    keep, _rank, sel, cvalid, n_valid = compact_select(
        sample_mask.reshape(RS), C)
    zero = torch.zeros((), device=sample_loc_w.device)
    cloc_w = torch.where(cvalid[:, None], sample_loc_w.reshape(RS, 3)[keep],
                         zero)
    craydir = batch.raydir[keep // SR]
    cpidx, _d2 = knn_query(cloc_w[:, None], cvalid[:, None], pc.xyz, grid,
                           cfg.query)                            # [C, 1, K]
    xyz_pers = w2pers(pc.xyz, batch.camrotc2w, batch.campos)
    sp = gather_points(pc, xyz_pers, cpidx, bwd=cfg.query.gather_bwd)
    cmask = cvalid & (cpidx[:, 0] >= 0).any(-1)
    cloc = torch.where(cmask[:, None],
                       w2pers(cloc_w, batch.camrotc2w, batch.campos), zero)
    cloc_w = torch.where(cmask[:, None], cloc_w, zero)
    agg = decode_compacted(params, cfg, sp, cloc, cloc_w, craydir, Rw2c,
                           compute_dtype)
    features, weight, conf_coeff, ray_valid, final_mask = expand_compact_many(
        [(agg.features, 0.0), (agg.weight, 0.0),
         (agg.conf_coefficient, conf_coeff_fill(cfg, pc)),
         (agg.ray_valid, False), (cmask, False)], keep, cvalid, R, SR)
    sample_loc = w2pers(sample_loc_w, batch.camrotc2w, batch.campos)
    sample_loc = torch.where(final_mask[..., None], sample_loc, zero)
    ray_mask = final_mask.any(-1)
    dropped = (n_valid - sel.to(torch.int32).sum()).to(torch.int32)
    out = _finalize(cfg, features, ray_valid, weight, conf_coeff, sample_loc,
                    sample_loc_w, ray_mask, decode_dropped=dropped,
                    train=train)
    return out._replace(neighbor_pidx=cpidx[:, 0])


def _dense_inputs(pc: PointCloud, batch: RayBatch, sample_pidx,
                  sample_loc_w, sample_mask, gather_bwd: str):
    """Gathered neighbor payloads, perspective sample locations (zero on
    slots without a neighbor) and per-slot ray directions of a dense
    [R, SR] query."""
    xyz_pers = w2pers(pc.xyz, batch.camrotc2w, batch.campos)
    sp = gather_points(pc, xyz_pers, sample_pidx, bwd=gather_bwd)
    sample_loc = w2pers(sample_loc_w, batch.camrotc2w, batch.campos)
    sample_loc = torch.where(sample_mask[..., None], sample_loc,
                             torch.zeros((), device=sample_loc.device))
    return sp, sample_loc, batch.raydir[:, None, :].expand(sample_loc_w.shape)


def _shade_at(params, pc: PointCloud, st: PointCloudStatic, grid, batch,
              cfg: PointNeRFConfig, sample_loc_w, sample_mask, prob: bool,
              compute_dtype, train: bool = False) -> RenderOutput:
    """KNN + gather + shade at explicit world shading locations: compacted
    when decode_capacity > 0 and not probing, dense otherwise."""
    if st.Rw2c.dim() == 3:
        raise not_ported("per-point rotations (editing)",
                         "Queue 1, remaining modules: edit.py")
    if cfg.query.decode_capacity > 0 and not prob:
        return shade_compacted(params, cfg, pc, grid, sample_loc_w,
                               sample_mask, batch, st.Rw2c,
                               compute_dtype=compute_dtype, train=train)
    sample_pidx, _d2 = knn_query(sample_loc_w, sample_mask, pc.xyz, grid,
                                 cfg.query)
    sample_mask = sample_mask & (sample_pidx >= 0).any(-1)
    sample_loc_w = torch.where(sample_mask[..., None], sample_loc_w,
                               torch.zeros((), device=sample_loc_w.device))
    sp, sample_loc, dirs = _dense_inputs(pc, batch, sample_pidx, sample_loc_w,
                                         sample_mask, cfg.query.gather_bwd)
    out = shade(params, cfg, sp, sample_loc, sample_loc_w, dirs, st.Rw2c,
                prob=prob, compute_dtype=compute_dtype, train=train)
    return out._replace(neighbor_pidx=sample_pidx)


def render_rays(params: Dict, pc: PointCloud, st: PointCloudStatic,
                grid: PointGrid, batch: RayBatch, cfg: PointNeRFConfig,
                train: bool = False, prob: bool = False,
                compute_dtype=torch.float32,
                generator: Optional[torch.Generator] = None,
                u: Optional[torch.Tensor] = None) -> RenderOutput:
    """Render a batch of rays against the neural point cloud (coarse pass):
    the compacted decode when decode_capacity > 0 and not probing, else the
    dense one (`query_points` + `shade`; a probe needs every [R, SR, K]
    lane for its argmax). With `train`, the ray samples are jittered by
    `cfg.render.train_jitter` from `u` [R, D] if given, else from
    `generator` (JAX: the `k_coarse` draw)."""
    check_envelope(cfg, batch.raydir.device, train=train)
    near, far = float(cfg.render.near_plane), float(cfg.render.far_plane)
    jitter = cfg.render.train_jitter if train else 0.0
    if cfg.query.decode_capacity > 0 and not prob:
        sample_loc_w, sample_mask = generate_shading_points(
            grid, batch.campos, batch.raydir, near, far, cfg.query,
            jitter=jitter, generator=generator, u=u,
            gen_name=effective_ray_generator(cfg),
            gen_kwargs=generator_kwargs(cfg))
        return _shade_at(params, pc, st, grid, batch, cfg, sample_loc_w,
                         sample_mask, prob=prob, compute_dtype=compute_dtype,
                         train=train)
    q = query_points(pc.xyz, grid, batch.campos, batch.raydir, near, far,
                     cfg.query, jitter=jitter, generator=generator, u=u,
                     gen_name=effective_ray_generator(cfg),
                     gen_kwargs=generator_kwargs(cfg))
    sp, sample_loc, dirs = _dense_inputs(pc, batch, q.sample_pidx,
                                         q.sample_loc_w, q.sample_mask,
                                         cfg.query.gather_bwd)
    out = shade(params, cfg, sp, sample_loc, q.sample_loc_w, dirs, st.Rw2c,
                prob=prob, compute_dtype=compute_dtype, train=train)
    return out._replace(neighbor_pidx=q.sample_pidx)
