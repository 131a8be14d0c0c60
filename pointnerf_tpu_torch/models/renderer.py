"""The Point-NeRF forward pipeline: query -> gather -> aggregate -> march.

Counterpart of `pointnerf_tpu/models/renderer.py`: `RayBatch`,
`RenderOutput`, `compute_ray_dist`, `_finalize`, `shade` (the dense decode,
with the prob-mode probe outputs), `decode_slots`, `compact_select`,
`expand_compact_many`, `conf_coeff_fill`, `decode_compacted`,
`shade_compacted`, `_shade_at`, `render_rays`, the fine pass
(`_fine_pass`) and the proposal-NeRF hybrid (`_hybrid_march`) — the coarse
render with the static-capacity compacted decode or the dense one
(decode_capacity=0, and every prob-mode probe), for inference and for
training (jittered samples, gradients), then the importance-resampled fine
pass and the z-merged march with the radiance field. The kernels of this
path: K1 (KNN select) inside `knn_query`, K3 (fused decode) and its
backward K4 inside `aggregate` (coarse and fine), K2 (fused march) for
every serving march — `_finalize` of both passes and the hybrid's merged
sequence; on the card they run wherever they compute the function,
whatever the fused flags say (`aggregator.decode_takes_kernel`,
`march_takes_kernel`). An editing composite's per-point Rw2c is gathered
per neighbor on every path (`neighbor_rot`) for the aggregator's rotations.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import DeviceLike, not_ported, resolve_device
from ..camera import w2pers
from ..config import (PointNeRFConfig, effective_ray_generator,
                      generator_kwargs)
from ..ops.fused_march import fused_march
from ..ops.grid import PointGrid
from ..ops.knn_select import MAX_QP
from ..ops.query import (_xla_cumprod, generate_shading_points, knn_query,
                         query_points, refine_ray_generation)
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
    # the fine pass (fine_sample_num > 0): a second decode at shading
    # points importance-resampled from the coarse blend weights
    fine_raycolor: Optional[torch.Tensor] = None            # [R, C]
    fine_neighbor_pidx: Optional[torch.Tensor] = None       # as neighbor_pidx
    # decoded point features [R, SR, 1 + C], kept for the hybrid's z-merge
    # (nerf_importance > 0) and dropped once it has marched them
    sample_features: Optional[torch.Tensor] = None
    # the hybrid: the coarse field pass's color, and the creation signals —
    # the blend mass the field samples carry in the merged march, their
    # expected world location and color
    nerf_coarse_raycolor: Optional[torch.Tensor] = None     # [R, C]
    nerf_mass: Optional[torch.Tensor] = None                # [R, 1]
    nerf_loc_w: Optional[torch.Tensor] = None               # [R, 3]
    nerf_color: Optional[torch.Tensor] = None               # [R, <=3]


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
    `render.fused_march` says, at any channel count — the card never runs a
    kernel's plain twin."""
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
    return kernel_func


def merged_march_takes_kernel(cfg: PointNeRFConfig, device: torch.device,
                              train: bool) -> bool:
    """Whether the hybrid's z-merged march is K2: on CUDA by the card's rule
    (`march_takes_kernel`: every serving radiance/alpha march); on the CPU
    never, whatever the flag — the JAX package marches the merged sequence
    with its plain march."""
    return device.type == "cuda" and march_takes_kernel(cfg, device, train)


def check_envelope(cfg: PointNeRFConfig, device: torch.device,
                   train: bool = False) -> None:
    """Raise before any work for a config the port does not implement: on
    CUDA one inside the fused envelope but past the port kernels' limits
    (`decode_takes_kernel`, `march_takes_kernel`; the fine pass and the
    hybrid's merged march take the same kernels), or a KNN on K1's route
    past its QP = 512 candidates."""
    decode_takes_kernel(cfg.agg, cfg.query.K,
                        cfg.train.compute_dtype == "bf16", device,
                        backward=train)
    march_takes_kernel(cfg, device, train)
    check_knn_envelope(cfg.query, device)


def check_knn_envelope(q, device: torch.device) -> None:
    """On CUDA, refuse a query on K1's route (prebuilt tables, NN > 0, no
    shell cut) whose table rows hold more than K1's MAX_QP candidates:
    `refresh_grid` calls it before it builds the tables."""
    qp = int(np.prod(q.kernel_size)) * q.P
    if (device.type == "cuda" and q.prebuild_neighbors and q.NN > 0
            and not q.shell_layered and qp > MAX_QP):
        raise not_ported(f"the KNN select kernel at QP={qp} (kernel_size "
                         f"{tuple(q.kernel_size)} x P={q.P})",
                         "Queue 2, K1 at QP > 512")


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
        sample_loc_w=sample_loc_w, decode_dropped=decode_dropped,
        sample_features=(features if cfg.render.nerf_importance > 0
                         else None))


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


def neighbor_rot(Rw2c, pidx):
    """A global [3, 3] Rw2c as it is; per-point rotations [N, 3, 3]
    (editing composites) gathered per neighbor, [..., K, 3, 3] (an invalid
    neighbor takes point 0's, and is masked downstream)."""
    if Rw2c is None or Rw2c.dim() != 3:
        return Rw2c
    return Rw2c[pidx.clamp(min=0).long()]


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
    agg = decode_compacted(params, cfg, sp, cloc, cloc_w, craydir,
                           neighbor_rot(Rw2c, cpidx), compute_dtype)
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
    out = shade(params, cfg, sp, sample_loc, sample_loc_w, dirs,
                neighbor_rot(st.Rw2c, sample_pidx), prob=prob,
                compute_dtype=compute_dtype, train=train)
    return out._replace(neighbor_pidx=sample_pidx)


def render_rays(params: Dict, pc: PointCloud, st: PointCloudStatic,
                grid: PointGrid, batch: RayBatch, cfg: PointNeRFConfig,
                train: bool = False, prob: bool = False,
                compute_dtype=torch.float32,
                generator: Optional[torch.Generator] = None,
                u: Optional[torch.Tensor] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None
                ) -> RenderOutput:
    """Render a batch of rays against the neural point cloud: the coarse
    pass (the compacted decode when decode_capacity > 0 and not probing,
    else the dense one — a probe needs every [R, SR, K] lane for its
    argmax), then the fine pass when fine_sample_num > 0 and the hybrid
    when nerf_importance > 0 and params hold "nerf".

    With `train` the draws are random: the coarse jitter
    (`cfg.render.train_jitter`) from `u` [R, D] if given, the fine pass's
    from draws["fine"] [R, fine_sample_num + 1], the hybrid's coarse field
    samples from draws["nerf_march"] [R, nerf_coarse_samples] and its
    importance samples from draws["nerf_importance"] [R, nerf_importance];
    each one missing is drawn from `generator` (in that order), or, without
    a generator, the pass is deterministic (JAX: no key)."""
    check_envelope(cfg, batch.raydir.device, train=train)
    draws = draws or {}
    near, far = float(cfg.render.near_plane), float(cfg.render.far_plane)
    jitter = cfg.render.train_jitter if train else 0.0
    if cfg.query.decode_capacity > 0 and not prob:
        sample_loc_w, sample_mask = generate_shading_points(
            grid, batch.campos, batch.raydir, near, far, cfg.query,
            jitter=jitter, generator=generator, u=u,
            gen_name=effective_ray_generator(cfg),
            gen_kwargs=generator_kwargs(cfg))
        out = _shade_at(params, pc, st, grid, batch, cfg, sample_loc_w,
                        sample_mask, prob=prob, compute_dtype=compute_dtype,
                        train=train)
    else:
        q = query_points(pc.xyz, grid, batch.campos, batch.raydir, near, far,
                         cfg.query, jitter=jitter, generator=generator, u=u,
                         gen_name=effective_ray_generator(cfg),
                         gen_kwargs=generator_kwargs(cfg))
        sp, sample_loc, dirs = _dense_inputs(pc, batch, q.sample_pidx,
                                             q.sample_loc_w, q.sample_mask,
                                             cfg.query.gather_bwd)
        out = shade(params, cfg, sp, sample_loc, q.sample_loc_w, dirs,
                    neighbor_rot(st.Rw2c, q.sample_pidx), prob=prob,
                    compute_dtype=compute_dtype, train=train)
        out = out._replace(neighbor_pidx=q.sample_pidx)
    gen = generator if train else None
    if cfg.render.fine_sample_num > 0:
        out = _fine_pass(params, pc, st, grid, batch, cfg, out, train,
                         compute_dtype, gen, draws.get("fine"))
    if cfg.render.nerf_importance > 0 and "nerf" in params:
        out = _hybrid_march(params, out, batch, cfg, train=train,
                            generator=gen, draws=draws,
                            compute_dtype=compute_dtype)
    return out


def _ray_t(out: RenderOutput, batch: RayBatch, fill: float) -> torch.Tensor:
    """Each shading point's ray parameter t [R, SR] (its depth along the
    unnormalized ray direction), `fill` where the slot is not valid."""
    rd2 = (batch.raydir * batch.raydir).sum(-1, keepdim=True)
    t = ((out.sample_loc_w - batch.campos[None, None, :])
         * batch.raydir[:, None, :]).sum(-1) / rd2
    return torch.where(out.ray_valid, t, torch.full_like(t, fill))


def _fine_pass(params, pc, st, grid, batch, cfg: PointNeRFConfig,
               out: RenderOutput, train: bool, compute_dtype, generator,
               u) -> RenderOutput:
    """The hierarchical fine pass: importance-resample fine_sample_num
    shading points (+ the coarse ones) from the coarse blend weights —
    recomputed from the coarse opacities with the configured blend — and
    shade them like the coarse pass (K1, K3, and K2 when serving, at
    SR' = fine_sample_num + SR). Adds fine_raycolor and
    fine_neighbor_pidx."""
    t = _ray_t(out, batch, float(cfg.render.far_plane))
    alpha = out.coarse_point_opacity
    acc = _xla_cumprod(1.0 - alpha + 1e-10)
    acc = torch.cat([torch.ones_like(acc[:, :1]), acc[:, :-1]], -1)
    blend = BLEND_FUNCS[cfg.render.which_blend_func]
    w = torch.where(out.ray_valid, blend(alpha, acc), torch.zeros_like(alpha))
    fine_pos, _seg, mid = refine_ray_generation(
        batch.campos, batch.raydir, cfg.render.fine_sample_num, t.detach(),
        w.detach(), jitter=cfg.render.train_jitter if train else 0.0,
        generator=generator, u=u)
    fine_mask = out.ray_mask[:, None].expand(mid.shape)
    fine = _shade_at(params, pc, st, grid, batch, cfg, fine_pos, fine_mask,
                     prob=False, compute_dtype=compute_dtype, train=train)
    return out._replace(fine_raycolor=fine.coarse_raycolor,
                        fine_neighbor_pidx=fine.neighbor_pidx)


def merge_samples(t_pts, valid, feats_p, z_i, feats_n):
    """The hybrid's z-merge: point samples (t_pts, valid [R, SR], features
    [R, SR, 1 + C], zeroed where not valid) and field samples (z_i
    [R, Ni], features [R, Ni, 1 + C]) in one stable sort by z, ties in
    input order (points first). Returns (z_s, idx_s — each merged slot's
    input index, >= SR for a field sample —, feats_s, valid_s)."""
    feats_p = torch.where(valid[..., None], feats_p,
                          torch.zeros((), device=feats_p.device))
    z_all = torch.cat([t_pts, z_i], -1)
    feats_all = torch.cat([feats_p, feats_n], -2)
    valid_all = torch.cat([valid, torch.ones(z_i.shape, dtype=torch.bool,
                                             device=valid.device)], -1)
    z_s, idx_s = torch.sort(z_all, dim=-1, stable=True)
    feats_s = feats_all.gather(
        1, idx_s[..., None].expand(-1, -1, feats_all.shape[-1]))
    return z_s, idx_s, feats_s, valid_all.gather(1, idx_s)


def _hybrid_march(params: Dict, out: RenderOutput, batch: RayBatch,
                  cfg: PointNeRFConfig, train: bool = False,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Dict[str, torch.Tensor]] = None,
                  compute_dtype=torch.float32) -> RenderOutput:
    """The proposal-NeRF hybrid: a coarse field pass gives a proposal
    distribution, `nerf_importance` z's are drawn from it and decoded by
    the field, merged in z with the point samples (a stable sort of
    [R, SR + Ni]; invalid point samples sit at far + 1, behind every
    field sample) and the merged sequence is marched once. Replaces
    coarse_raycolor and coarse_is_background; the points-only march stays
    in the other outputs. On CUDA a serving march is K2, its blend weights
    recomputed from K2's opacity with the exclusive cumprod; training and
    the CPU take the plain march, as the JAX package does."""
    from .nerf_branch import coarse_ray_march, importance_z, nerf_eval
    r = cfg.render
    draws = draws or {}
    dev = batch.raydir.device
    t_pts = _ray_t(out, batch, float(r.far_plane) + 1.0)
    z_c, w_c, rgb_c = coarse_ray_march(
        params["nerf"], batch.campos, batch.raydir, cfg, train=train,
        generator=generator, u=draws.get("nerf_march"),
        compute_dtype=compute_dtype)
    z_i = importance_z(z_c, w_c.detach(), r.nerf_importance, det=not train,
                       generator=generator, u=draws.get("nerf_importance"))
    pts = batch.campos[None, None, :] + z_i[..., None] * batch.raydir[:, None]
    feats_n = nerf_eval(params["nerf"], pts,
                        batch.raydir[:, None, :].expand(pts.shape), cfg,
                        compute_dtype)                           # [R, Ni, 1+C]
    z_s, idx_s, feats_s, valid_s = merge_samples(
        t_pts, out.ray_valid, out.sample_features, z_i, feats_n)
    vz = cfg.query.vsize[2]
    dists = torch.cat([z_s[:, 1:] - z_s[:, :-1],
                       torch.full_like(z_s[:, :1], vz)], -1)
    # a gap ending at an invalid sample (the block at far + 1) is clamped to
    # one voxel: the last valid sample would otherwise absorb it
    nxt_invalid = torch.cat([~valid_s[:, 1:],
                             torch.ones_like(valid_s[:, :1])], -1)
    dists = torch.where(nxt_invalid, torch.full_like(dists, vz), dists)
    tonemap = TONEMAP_FUNCS[r.which_tonemap_func]
    bg = torch.tensor(r.bg_color, dtype=torch.float32, device=dev)
    if cfg.agg.shading_color_channel_num != 3:
        bg = torch.zeros(cfg.agg.shading_color_channel_num, device=dev)
    if merged_march_takes_kernel(cfg, dev, train):
        ray_color, opacity, bg_trans = fused_march(
            dists.contiguous(), valid_s.contiguous(), feats_s.contiguous(), bg)
        bw = opacity * exclusive_transmission(opacity)
    else:
        (ray_color, _pc, _op, _acc, bw, bg_trans, _bgw) = ray_march(
            dists, valid_s, feats_s, RENDER_FUNCS[r.which_render_func],
            BLEND_FUNCS[r.which_blend_func], bg)
        bw = bw[..., 0]
    # the creation signals: the blend mass of the field samples (sorted
    # index >= SR), their expected location and color
    SR = out.ray_valid.shape[-1]
    w_n = torch.where(idx_s >= SR, bw, torch.zeros_like(bw))     # [R, SR+Ni]
    mass = w_n.sum(-1, keepdim=True)
    zbar = (w_n * z_s).sum(-1, keepdim=True) / (mass + 1e-8)
    loc_w = batch.campos[None, :] + zbar * batch.raydir
    col_n = (w_n[..., None] * feats_s[..., 1:4]).sum(-2) / (mass + 1e-8)
    return out._replace(coarse_raycolor=tonemap(ray_color),
                        coarse_is_background=bg_trans,
                        nerf_coarse_raycolor=tonemap(rgb_c),
                        sample_features=None, nerf_mass=mass,
                        nerf_loc_w=loc_w, nerf_color=col_n)
