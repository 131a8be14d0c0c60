"""Point-sharded, ray-data-parallel rendering and training over a (dp, mp)
mesh of torch.distributed ranks.

Counterpart of `pointnerf_tpu/parallel/sharded.py` (`ShardedScene`,
`partition_points`, `partition_points_multiseq`, `build_sharded_scene`,
`_render_local`, `_shade_blocks_dense`, `_render_local_compact`,
`_fine_local`, `_local_grid`, `make_sharded_train_step` (with
`sharded_loss_and_grads`, the counterpart of `train/step.loss_and_grads`),
`make_sharded_eval_step`, `make_sharded_neural2d_step`,
`create_sharded_neural2d_state`, `sharded_prune`, `sharded_grow`,
`create_sharded_train_state`; JAX's `_place_opt_state` is `_on(opt_state,
mesh.device)` here, as every leaf lives on the rank's device). Where JAX
runs one program under `shard_map`, here every rank runs these functions
on its own part:

  - rays are split over `dp`: a step takes the global batch and each rank
    works on its dp row's rays (`_dp_rows`); MLP gradients are averaged
    over the mesh;
  - the point cloud, its grids and tables and its Adam moments are split
    over `mp`: each rank holds its own shard. It runs the KNN (K1 on its
    prebuilt tables) against its own points for all of its dp row's slots,
    gathers the payloads, and one all_to_all (`collectives.all_to_all`)
    hands every rank all shards' candidates for its 1/mp block of rays. A
    global top-K over the mp * K merged candidates (a stable sort: ties to
    the lowest index, as `lax.top_k`) reproduces the single-device KNN, and
    the rank decodes (K3; K4 under a gradient) and marches (K2 when
    serving) its own block;
  - slot selection reads the union occupancy of all shards, an int32 sum
    over mp made once per grid build.

Gradients flow back through the all_to_all's transpose (the reverse
all_to_all), so the point gradients land on the owning shard. The MLP
gradients are averaged over (dp, mp), the point gradients over dp and
divided by mp, as JAX normalizes them.

One difference from JAX, on purpose: `build_sharded_scene` takes the
largest dilated-occupied cell count of the shards (a max over mp), and when
it exceeds the tables' capacity every rank rebuilds with max_d sized from
it, as `train/step.refresh_grid` does for one device. JAX's sharded build
truncates the tables silently.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..camera import w2pers
from ..config import (PointNeRFConfig, effective_ray_generator,
                      generator_kwargs)
from ..models.losses import compute_losses, mse2psnr
from ..models.points import (DEAD_XYZ, PointCloud, PointCloudStatic,
                             SampledPoints, gather_points, grow,
                             make_point_cloud, prune, round_capacity)
from ..models.ray_march import BLEND_FUNCS
from ..models.renderer import (RayBatch, RenderOutput, _compute_dtype,
                               _finalize, _hybrid_march, _ray_t,
                               check_envelope, compact_select,
                               conf_coeff_fill, decode_compacted,
                               decode_slots, expand_compact_many, shade)
from ..ops.grid import PointGrid, build_grid
from ..ops.query import (_xla_cumprod, generate_shading_points, knn_query,
                         refine_ray_generation)
from ..train.grow import (_is_point_leaf, pad_point_opt_state,
                          permute_point_opt_state)
from ..train.optim import (alternated_update, apply_grad_flags,
                           freeze_points, init_optimizer, tree_leaves,
                           tree_map)
from ..train.step import TrainState
from .collectives import (all_gather, all_to_all, pmax, pmean_items,
                          pmean_tree, psum)
from .mesh import Mesh


class ShardedScene(NamedTuple):
    """A rank's grids: its own point shard's buckets and tables, with the
    union occupancy and every shard's live count (the same on every rank).
    JAX keeps these with a leading [mp] axis over the mesh; each rank here
    holds its own row of them."""
    num_active: torch.Tensor   # [mp] int32 — live points per shard
    Rw2c: torch.Tensor         # [3, 3]
    vox_slot: torch.Tensor     # [G] int32 — this shard's voxel -> slot
    bucket_pnt: torch.Tensor   # [max_o, P] int32
    bucket_cnt: torch.Tensor   # [max_o] int32
    bucket_xyz: torch.Tensor   # [max_o, P, 3]
    occ_union: torch.Tensor    # [G] int8 — union dilated occupancy
    # this shard's prebuilt neighbor tables (cfg.query.prebuild_neighbors):
    # a shading point outside the shard's dilation has no local candidate,
    # so the merged top-K still equals the single-device KNN
    vox_dslot: Optional[torch.Tensor] = None  # [G] int32
    nbr_xyz: Optional[torch.Tensor] = None    # [max_d, 3 * Q * P]
    nbr_pid: Optional[torch.Tensor] = None    # [max_d, Q * P] int32
    # the shards' dilated-occupied cell lists side by side (duplicates
    # across shards are harmless)
    occ_vids: Optional[torch.Tensor] = None   # [mp * max_dv] int32, pad G
    # the table size the build settled on (0: the config's); later
    # rebuilds of this scene start from it
    max_d: int = 0


def _shard_selections(n: int, mp: int) -> List[np.ndarray]:
    """Round-robin: point i goes to shard i % mp."""
    return [np.arange(j, n, mp) for j in range(mp)]


def _stack_or_pick(shards: List[PointCloud], shard: Optional[int],
                   device) -> PointCloud:
    if shard is not None:
        return PointCloud(*[t.to(device) for t in shards[shard]])
    return PointCloud(*[torch.stack(xs).to(device) for xs in zip(*shards)])


def partition_points(xyz: np.ndarray, generator: Optional[torch.Generator],
                     cfg: PointNeRFConfig, mp: int,
                     features: Optional[np.ndarray] = None,
                     color: Optional[np.ndarray] = None,
                     dirs: Optional[np.ndarray] = None,
                     conf: Optional[np.ndarray] = None,
                     capacity_per_shard: Optional[int] = None,
                     shard: Optional[int] = None, device=None
                     ) -> Tuple[PointCloud, torch.Tensor]:
    """Round-robin partition of a raw cloud into mp equal shards (point i ->
    shard i % mp, which balances spatially sorted clouds). Returns
    (PointCloud, num_active [mp] int32): the cloud's leaves are
    [mp, cap_s, ...], or with `shard` that shard's [cap_s, ...] alone.
    Features not given are drawn from `generator` (a CPU generator) shard
    by shard, so every rank that partitions with the same seed holds the
    same shards. On the card unless `device="cpu"`."""
    per = _shard_selections(xyz.shape[0], mp)
    cap = capacity_per_shard or round_capacity(max(len(p) for p in per))
    shards, counts = [], []
    for sel in per:
        pc_j, st_j = make_point_cloud(
            xyz[sel], generator, cfg.points, cfg.agg.point_features_dim,
            features=None if features is None else features[sel],
            color=None if color is None else color[sel],
            dirs=None if dirs is None else dirs[sel],
            conf=None if conf is None else conf[sel],
            capacity=cap, device="cpu")
        shards.append(pc_j)
        counts.append(int(st_j.num_active))
    dev = resolve_device(device)
    return (_stack_or_pick(shards, shard, dev),
            torch.tensor(counts, dtype=torch.int32, device=dev))


def partition_points_multiseq(clouds: Sequence[Dict[str, np.ndarray]],
                              generator: Optional[torch.Generator],
                              cfg: PointNeRFConfig, mp: int,
                              capacity_per_shard: Optional[int] = None,
                              shard: Optional[int] = None, device=None):
    """Partition a multi-sequence scene (one cloud per sequence, as
    `data/waymo.load_multiseq` gives them: dicts with "xyz" and optional
    "feature" / "color" / "dirs" / "conf") onto the mp point axis.

    With mp >= n_seq the shards are split among the sequences in proportion
    to their point counts (at least one each) and each sequence deals its
    points round-robin over its shards; with mp < n_seq sequence j goes
    whole to shard j % mp. A payload that some parts of a shard lack is
    filled as make_point_cloud fills it — features from numpy's
    RandomState(1000 + shard), as JAX draws them. Returns (PointCloud,
    num_active [mp], shard_seq [mp] — the owning sequence of each shard,
    -1 for a mixed one); `shard` as `partition_points`."""
    n_seq = len(clouds)
    if n_seq < 1 or mp < 1:
        raise ValueError(f"need >= 1 sequence and mp >= 1, got {n_seq}, {mp}")
    sizes = [c["xyz"].shape[0] for c in clouds]

    def seq_arrays(j):
        c = clouds[j]
        return (np.asarray(c["xyz"], np.float32), c.get("feature"),
                c.get("color"), c.get("dirs"), c.get("conf"))

    shard_parts: list = [[] for _ in range(mp)]
    shard_seq = np.full((mp,), -1, np.int64)
    if mp >= n_seq:
        alloc = np.maximum(1, np.floor(
            np.asarray(sizes, np.float64) / max(sum(sizes), 1) * mp)
            .astype(np.int64))
        while alloc.sum() > mp:
            alloc[np.argmax(alloc)] -= 1
        while alloc.sum() < mp:
            alloc[np.argmin(alloc / np.maximum(np.asarray(sizes), 1))] += 1
        s0 = 0
        for j in range(n_seq):
            group = list(range(s0, s0 + int(alloc[j])))
            s0 += int(alloc[j])
            xyz_j, *rest = seq_arrays(j)
            for gi, s in enumerate(group):
                sel = np.arange(gi, xyz_j.shape[0], len(group))
                shard_parts[s].append(
                    (xyz_j[sel],) + tuple(None if r is None else
                                          np.asarray(r)[sel] for r in rest))
                shard_seq[s] = j
    else:
        for j in range(n_seq):
            xyz_j, *rest = seq_arrays(j)
            s = j % mp
            shard_parts[s].append(
                (xyz_j,) + tuple(None if r is None else np.asarray(r)
                                 for r in rest))
            shard_seq[s] = j if shard_seq[s] in (-1, j) else -1

    def _default(i, n, rng):
        if i == 1:   # feature: make_point_cloud's "rand" init
            if cfg.points.feature_init_method == "zeros":
                return np.zeros((n, cfg.agg.point_features_dim), np.float32)
            return rng.rand(n, cfg.agg.point_features_dim).astype(
                np.float32) * 0.01
        if i == 4:   # conf
            return np.full((n, 1), cfg.points.default_conf, np.float32)
        return np.zeros((n, 3), np.float32)  # color / dirs

    def cat(parts, i, rng=None):
        if all(p[i] is None for p in parts):
            return None
        return np.concatenate(
            [p[i] if p[i] is not None else _default(i, p[0].shape[0], rng)
             for p in parts])

    per = [cat(p, 0) for p in shard_parts]
    cap = capacity_per_shard or round_capacity(max(x.shape[0] for x in per))
    shards, counts = [], []
    for s in range(mp):
        rng = np.random.RandomState(1000 + s)
        pc_s, st_s = make_point_cloud(
            per[s], generator, cfg.points, cfg.agg.point_features_dim,
            features=cat(shard_parts[s], 1, rng),
            color=cat(shard_parts[s], 2, rng),
            dirs=cat(shard_parts[s], 3, rng),
            conf=cat(shard_parts[s], 4, rng),
            capacity=cap, device="cpu")
        shards.append(pc_s)
        counts.append(int(st_s.num_active))
    dev = resolve_device(device)
    return (_stack_or_pick(shards, shard, dev),
            torch.tensor(counts, dtype=torch.int32, device=dev), shard_seq)


def build_sharded_scene(pc_local: PointCloud, num_active: torch.Tensor,
                        cfg: PointNeRFConfig, mesh: Mesh,
                        Rw2c: Optional[torch.Tensor] = None,
                        max_d: int = 0) -> ShardedScene:
    """Each rank builds its own shard's grid (and tables), then the union
    occupancy (an int32 sum over mp, > 0) and the union cell list (the
    shards' lists gathered over mp). Rebuild only when the point set
    changes. `max_d` > 0 overrides the config's table size (a later
    rebuild passes the scene's own).

    The tables are never truncated: when the largest shard's
    dilated-occupied cell count (a max over mp) exceeds the tables'
    capacity, every rank rebuilds with max_d = 1.25 x that count, rounded
    up to 4096, and prints it (JAX's sharded build truncates)."""
    dev = pc_local.xyz.device
    if Rw2c is None:
        Rw2c = torch.eye(3, dtype=torch.float32, device=dev)
    q = cfg.query if not max_d else dataclasses.replace(cfg.query,
                                                         max_d=max_d)
    n_local = num_active[mesh.m].to(dev)
    grid = build_grid(pc_local.xyz, n_local, q)
    nd = int(pmax(grid.num_dil.reshape(1), mesh, "mp")[0])
    caps = [grid.occ_vids.shape[0]]
    if grid.nbr_pid is not None:
        caps.append(grid.nbr_pid.shape[0])
    if nd > min(caps):
        new_max_d = -(-int(nd * 1.25) // 4096) * 4096
        print(f"[grid] rank {mesh.rank}: a shard has {nd} dilated-occupied "
              f"cells, past the table envelope {min(caps)}; every rank "
              f"rebuilds with max_d={new_max_d}", flush=True)
        q = dataclasses.replace(q, max_d=new_max_d)
        grid = build_grid(pc_local.xyz, n_local, q)
    occ_union = (psum(grid.vox_occ.to(torch.int32), mesh, "mp") > 0
                 ).to(torch.int8)
    occ_vids = all_gather(grid.occ_vids, mesh, "mp", 0)
    return ShardedScene(num_active=num_active.to(dev), Rw2c=Rw2c.to(dev),
                        vox_slot=grid.vox_slot, bucket_pnt=grid.bucket_pnt,
                        bucket_cnt=grid.bucket_cnt,
                        bucket_xyz=grid.bucket_xyz, occ_union=occ_union,
                        vox_dslot=grid.vox_dslot, nbr_xyz=grid.nbr_xyz,
                        nbr_pid=grid.nbr_pid, occ_vids=occ_vids,
                        max_d=q.max_d)


def _local_grid(scene: ShardedScene) -> PointGrid:
    """The rank's shard grid with the union occupancy in place of its own:
    slot selection sees every shard's points, the KNN only this shard's."""
    return PointGrid(vox_slot=scene.vox_slot, vox_occ=scene.occ_union,
                     bucket_pnt=scene.bucket_pnt, bucket_cnt=scene.bucket_cnt,
                     num_occ=torch.zeros((), dtype=torch.int32,
                                         device=scene.vox_slot.device),
                     bucket_xyz=scene.bucket_xyz, vox_dslot=scene.vox_dslot,
                     nbr_xyz=scene.nbr_xyz, nbr_pid=scene.nbr_pid,
                     occ_vids=scene.occ_vids)


def _dp_rows(batch: RayBatch, mesh: Mesh) -> RayBatch:
    """The rank's dp row of a global ray batch (rows d * R / dp on)."""
    R = batch.raydir.shape[0]
    if R % mesh.size:
        raise ValueError(f"{R} rays do not split over the mesh "
                         f"{mesh.dp} x {mesh.mp}")
    Rl = R // mesh.dp
    s = slice(mesh.d * Rl, (mesh.d + 1) * Rl)
    gt = batch.gt_image
    return batch._replace(raydir=batch.raydir[s], pixel_idx=batch.pixel_idx[s],
                          gt_image=None if gt is None else gt[s])


def _block(a: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block (mp column m) of a dp row's rays."""
    rs = a.shape[0] // mesh.mp
    return a[mesh.m * rs:(mesh.m + 1) * rs]


def _merge_candidates(sp: SampledPoints, d2: torch.Tensor, K: int,
                      mesh: Mesh) -> Tuple[SampledPoints, torch.Tensor]:
    """Exchange the local candidates (one all_to_all of the packed payload
    rows and distances) and keep the K nearest of the mp * K merged ones
    per slot, ties to the lowest merged index (lax.top_k's order).
    Returns (merged candidates, their d2 [..., K], inf where empty)."""
    d2 = torch.where(sp.mask, d2, torch.full_like(d2, float("inf")))
    parts = [sp.xyz, sp.xyz_pers, sp.features, sp.conf, sp.color, sp.dirs]
    widths = [p.shape[-1] for p in parts]
    rows = torch.cat(parts + [d2.detach()[..., None].to(sp.xyz.dtype)], -1)
    rows = all_to_all(rows, mesh)                       # [Rb, S, mp*K, W]
    d2m = rows[..., -1].detach()
    if mesh.mp > 1:
        sel = torch.sort(d2m, dim=-1, stable=True).indices[..., :K]
        rows = rows.gather(2, sel[..., None].expand(-1, -1, -1,
                                                    rows.shape[-1]))
        d2m = d2m.gather(2, sel)
    pieces = rows[..., :-1].split(widths, dim=-1)
    return SampledPoints(*pieces, mask=torch.isfinite(d2m)), d2m


def _render_local(mlp_params, pc_local: PointCloud, grid: PointGrid, Rw2c,
                  batch: RayBatch, cfg: PointNeRFConfig, mesh: Mesh,
                  train: bool, prob: bool = False,
                  compute_dtype=torch.float32,
                  generator: Optional[torch.Generator] = None,
                  u: Optional[torch.Tensor] = None,
                  draws: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Tuple[RenderOutput, Optional[torch.Tensor]]:
    """A rank's forward over its dp row's rays `batch`: ray samples and slot
    selection for the whole row (the same on every rank of the row), local
    KNN, the all_to_all merge, and the decode and march of its own block.
    Returns (RenderOutput over its R / (dp mp) rays, their ground truth).

    The draws are the same on every rank of the mesh, as JAX's key is
    replicated: the coarse jitter `u` [Rl, D] for the row, draws["fine"]
    [rs, fine + 1] and the hybrid's draws["nerf_march"] / ["nerf_importance"]
    for a block — each drawn from `generator` when not given (ranks whose
    generators start equal stay equal), none without a generator (JAX: no
    key)."""
    q = cfg.query
    check_envelope(cfg, batch.raydir.device, train=train)
    draws = draws or {}
    Rl = batch.raydir.shape[0]
    if Rl % mesh.mp:
        raise ValueError(f"rays per dp row ({Rl}) must divide by mp "
                         f"({mesh.mp})")
    jitter = cfg.render.train_jitter if train else 0.0
    gen = generator if train else None
    sample_loc_w, sample_mask = generate_shading_points(
        grid, batch.campos, batch.raydir, float(cfg.render.near_plane),
        float(cfg.render.far_plane), q, jitter=jitter, generator=gen,
        gen_name=effective_ray_generator(cfg),
        gen_kwargs=generator_kwargs(cfg), u=u if train else None)
    if q.decode_capacity > 0 and not prob:
        out, gt_b = _render_local_compact(
            mlp_params, pc_local, grid, Rw2c, batch, cfg, sample_loc_w,
            sample_mask, mesh, compute_dtype, train=train)
    else:
        out, gt_b = _shade_blocks_dense(
            mlp_params, pc_local, grid, Rw2c, batch, cfg, sample_loc_w,
            sample_mask, mesh, compute_dtype, train=train, prob=prob)
    if cfg.render.fine_sample_num > 0 and not prob:
        out = _fine_local(mlp_params, pc_local, grid, Rw2c, batch, cfg, out,
                          mesh, compute_dtype, train, gen, draws.get("fine"))
    if cfg.render.nerf_importance > 0 and "nerf" in mlp_params:
        # the field MLP is replicated and `out` is this rank's block, so the
        # merged march is local: only the block's ray directions are needed
        out = _hybrid_march(mlp_params, out,
                            batch._replace(raydir=_block(batch.raydir, mesh)),
                            cfg, train=train, generator=gen, draws=draws,
                            compute_dtype=compute_dtype)
    return out, gt_b


def _shade_blocks_dense(mlp_params, pc_local: PointCloud, grid: PointGrid,
                        Rw2c, batch: RayBatch, cfg: PointNeRFConfig,
                        sample_loc_w, sample_mask, mesh: Mesh, compute_dtype,
                        train: bool, prob: bool = False):
    """Dense sharded shading: local KNN over the row's [Rl, SR] slots, the
    all_to_all merge, and the rank's block shaded (with the probe outputs
    under `prob`)."""
    q = cfg.query
    pidx, d2 = knn_query(sample_loc_w, sample_mask, pc_local.xyz, grid, q)
    xyz_pers = w2pers(pc_local.xyz, batch.camrotc2w, batch.campos)
    sp = gather_points(pc_local, xyz_pers, pidx, bwd=q.gather_bwd)
    merged, _d2 = _merge_candidates(sp, d2, q.K, mesh)  # [rs, SR, K, ...]
    loc_w = _block(sample_loc_w, mesh)
    # a slot without a neighbor drops out, as in query_points: its z must
    # not leak into the cummax ray distances of later slots
    loc_m = _block(sample_mask, mesh) & merged.mask.any(-1)
    raydir_b = _block(batch.raydir, mesh)
    gt_b = (None if batch.gt_image is None
            else _block(batch.gt_image, mesh))
    zero = torch.zeros((), device=loc_w.device)
    sample_loc = torch.where(
        loc_m[..., None], w2pers(loc_w, batch.camrotc2w, batch.campos), zero)
    ray_dirs = raydir_b[:, None, :].expand(loc_w.shape)
    out = shade(mlp_params, cfg, merged, sample_loc, loc_w, ray_dirs, Rw2c,
                prob=prob, compute_dtype=compute_dtype, train=train)
    return out, gt_b


def _render_local_compact(mlp_params, pc_local: PointCloud, grid: PointGrid,
                          Rw2c, batch: RayBatch, cfg: PointNeRFConfig,
                          sample_loc_w, sample_mask, mesh: Mesh,
                          compute_dtype, train: bool = False):
    """Compacted sharded shading: each block of rs rays compacts its rs * SR
    slots to Cb (selection used the union occupancy, so every rank of the
    row computes the same bookkeeping); the local KNN (one K1 launch), the
    payload gather and the all_to_all run on the [mp * Cb] compact slots,
    the rank decodes its block's merged candidates and scatters them back
    into its dense [rs, SR] frame."""
    q = cfg.query
    compute_dtype = _compute_dtype(cfg, compute_dtype)
    mp = mesh.mp
    Rl, SR = sample_mask.shape
    rs = Rl // mp
    Cb = decode_slots(cfg, rs * SR)
    blocks = [compact_select(vb, Cb) for vb in sample_mask.reshape(mp, rs * SR)]
    keep = torch.stack([b[0] for b in blocks])               # [mp, Cb]
    cvalid = torch.stack([b[3] for b in blocks])
    dev = sample_loc_w.device
    zero = torch.zeros((), device=dev)
    keep_glob = (keep + (torch.arange(mp, device=dev) * rs * SR)[:, None]
                 ).reshape(mp * Cb)
    cv_all = cvalid.reshape(mp * Cb)
    cloc_w_all = torch.where(cv_all[:, None],
                             sample_loc_w.reshape(Rl * SR, 3)[keep_glob], zero)
    pidx, d2 = knn_query(cloc_w_all[:, None], cv_all[:, None], pc_local.xyz,
                         grid, q)                          # [mp * Cb, 1, K]
    xyz_pers = w2pers(pc_local.xyz, batch.camrotc2w, batch.campos)
    sp = gather_points(pc_local, xyz_pers, pidx, bwd=q.gather_bwd)
    merged, _d2 = _merge_candidates(sp, d2, q.K, mesh)  # [Cb, 1, K, ...]

    keep_my, _rank, sel_my, cvalid_my, nv_my = blocks[mesh.m]
    loc_w_blk = _block(sample_loc_w, mesh)                 # [rs, SR, 3]
    raydir_b = _block(batch.raydir, mesh)
    gt_b = (None if batch.gt_image is None
            else _block(batch.gt_image, mesh))
    cmask = cvalid_my & merged.mask[:, 0].any(-1)          # [Cb]
    cloc_w = torch.where(cmask[:, None],
                         loc_w_blk.reshape(rs * SR, 3)[keep_my], zero)
    craydir = raydir_b[keep_my // SR]
    cloc = torch.where(cmask[:, None],
                       w2pers(cloc_w, batch.camrotc2w, batch.campos), zero)
    agg = decode_compacted(mlp_params, cfg, merged, cloc, cloc_w, craydir,
                           Rw2c, compute_dtype)
    features, weight, conf_coeff, ray_valid, final_mask = expand_compact_many(
        [(agg.features, 0.0), (agg.weight, 0.0),
         (agg.conf_coefficient, conf_coeff_fill(cfg, pc_local)),
         (agg.ray_valid, False), (cmask, False)],
        keep_my, cvalid_my, rs, SR)
    sample_loc = torch.where(
        final_mask[..., None],
        w2pers(loc_w_blk, batch.camrotc2w, batch.campos), zero)
    dropped = (nv_my - sel_my.to(torch.int32).sum()).to(torch.int32)
    out = _finalize(cfg, features, ray_valid, weight, conf_coeff, sample_loc,
                    loc_w_blk, final_mask.any(-1), decode_dropped=dropped,
                    train=train)
    return out, gt_b


def _fine_local(mlp_params, pc_local: PointCloud, grid: PointGrid, Rw2c,
                batch: RayBatch, cfg: PointNeRFConfig, out: RenderOutput,
                mesh: Mesh, compute_dtype, train: bool,
                generator: Optional[torch.Generator],
                u: Optional[torch.Tensor]) -> RenderOutput:
    """The sharded fine pass: the fine locations depend on the coarse blend
    weights, which only the owning rank has for its block, so each rank
    importance-resamples its own block (the draw `u` [rs, fine + 1] the
    same on every rank, as JAX's mp-replicated key draws it), one tiled
    all_gather over mp replicates every block's fine positions and masks,
    and from there the flow is the coarse one."""
    raydir_b = _block(batch.raydir, mesh)
    t = _ray_t(out, batch._replace(raydir=raydir_b),
               float(cfg.render.far_plane))
    alpha = out.coarse_point_opacity
    acc = _xla_cumprod(1.0 - alpha + 1e-10)
    acc = torch.cat([torch.ones_like(acc[:, :1]), acc[:, :-1]], -1)
    blend = BLEND_FUNCS[cfg.render.which_blend_func]
    w = torch.where(out.ray_valid, blend(alpha, acc), torch.zeros_like(alpha))
    fine_pos, _seg, mid = refine_ray_generation(
        batch.campos, raydir_b, cfg.render.fine_sample_num, t.detach(),
        w.detach(), jitter=cfg.render.train_jitter if train else 0.0,
        generator=generator, u=u)
    fine_mask = out.ray_mask[:, None].expand(mid.shape)
    pos_all = all_gather(fine_pos, mesh, "mp", 0)
    mask_all = all_gather(fine_mask.contiguous(), mesh, "mp", 0)
    if cfg.query.decode_capacity > 0:
        f_out, _ = _render_local_compact(
            mlp_params, pc_local, grid, Rw2c, batch, cfg, pos_all, mask_all,
            mesh, compute_dtype, train=train)
    else:
        f_out, _ = _shade_blocks_dense(
            mlp_params, pc_local, grid, Rw2c, batch, cfg, pos_all, mask_all,
            mesh, compute_dtype, train=train)
    return out._replace(fine_raycolor=f_out.coarse_raycolor)


def _value_and_grad(fn, params):
    """(total, items, grads) of fn(params) -> (total, items); gradients in
    the layout of `params`, zeros where none flows."""
    if torch.is_inference_mode_enabled():
        raise RuntimeError("training needs autograd: do not call it under "
                           "torch.inference_mode")
    params = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        total, items = fn(params)
        leaves = tree_leaves(params)
        gl = torch.autograd.grad(total, leaves, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, gl)])
    items = {k: v.detach() for k, v in items.items()}
    return total.detach(), items, tree_map(lambda _p: next(it), params)


def _normalize_grads(grads: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """JAX's normalization: the global loss is the mean of the ranks' block
    losses. Replicated parameters (the MLPs, a head) take the mean of the
    ranks' gradients over (dp, mp); the point gradients already arrive
    summed over the mp consumers through the all_to_all's transpose, so they
    take the mean over dp and 1 / mp."""
    out = {}
    for k, g in grads.items():
        if k == "points":
            out[k] = tree_map(lambda t: t / mesh.mp,
                              pmean_tree(g, mesh, "dp"))
        else:
            out[k] = pmean_tree(g, mesh, ("dp", "mp"))
    return out


def sharded_loss_and_grads(state: TrainState, scene: ShardedScene,
                           batch: RayBatch, cfg: PointNeRFConfig, mesh: Mesh,
                           u: Optional[torch.Tensor] = None,
                           draws: Optional[Dict[str, torch.Tensor]] = None):
    """(total, items, grads) of one sharded step before the grad flags: the
    loss of the mesh (the mean of the ranks' block losses), its items
    averaged over the mesh (n_decode_dropped summed) and the gradients
    normalized as JAX normalizes them (`_normalize_grads`), the same on
    every rank but the point gradients, which are the rank's shard's. The
    counterpart of `train/step.loss_and_grads`; `u` / `draws` as
    `_render_local`'s, else drawn from `state.key`."""
    b = _dp_rows(batch, mesh)
    grid = _local_grid(scene)

    def local_loss(p):
        pc_local = freeze_points(p["points"], cfg.points)
        out, gt = _render_local(p["mlp"], pc_local, grid, scene.Rw2c, b, cfg,
                                mesh, train=True, generator=state.key, u=u,
                                draws=draws)
        total, items = compute_losses(out, gt, cfg.loss)
        items["mse"] = ((out.coarse_raycolor - gt) ** 2).mean()
        if out.decode_dropped is not None:
            items["n_decode_dropped"] = out.decode_dropped
        return total, items

    total, items, grads = _value_and_grad(local_loss, state.params)
    dropped = items.pop("n_decode_dropped", None)
    grads = _normalize_grads(grads, mesh)
    items["loss_total"] = total
    items = pmean_items(items, mesh, ("dp", "mp"))
    if dropped is not None:
        # the overflow of every block of the mesh
        items["n_decode_dropped"] = psum(dropped.float(), mesh, ("dp", "mp"))
    items["psnr"] = mse2psnr(items.pop("mse"))
    return items["loss_total"], items, grads


def make_sharded_train_step(cfg: PointNeRFConfig, mesh: Mesh):
    """step(state, scene, batch, u=None, draws=None) -> (state, items): one
    training step over the global ray batch (each rank renders its block;
    `u` / `draws` as `_render_local`'s, else drawn from `state.key`):
    `sharded_loss_and_grads`, the grad flags, the two-group Adam step.
    State: params["mlp"] replicated (bit-equal on every rank after every
    step: the all-reduced gradients are the same bits everywhere),
    params["points"] the rank's shard, and their Adam moments with them."""

    def step(state: TrainState, scene: ShardedScene, batch: RayBatch,
             u: Optional[torch.Tensor] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None):
        _total, items, grads = sharded_loss_and_grads(state, scene, batch,
                                                      cfg, mesh, u, draws)
        grads["points"] = apply_grad_flags(grads["points"], cfg.points)
        with torch.no_grad():
            updates, new_opt = alternated_update(
                grads, state.opt_state, state.step, cfg.train.alter_step,
                cfg)
            new_params = tree_map(lambda p, du: p + du, state.params,
                                  updates)
        return TrainState(params=new_params, opt_state=new_opt,
                          step=state.step + 1, key=state.key), items

    return step


# the outputs the sharded eval returns (JAX's out_specs: every other field
# is None — neighbor ids are shard-local, decode_dropped rides the training
# items)
EVAL_CORE = ("coarse_raycolor", "coarse_is_background", "coarse_depth",
             "coarse_point_opacity", "queried_shading", "ray_mask", "weight",
             "conf_coefficient", "ray_valid", "sample_loc_w")
EVAL_PROB = ("ray_max_shading_opacity", "ray_max_sample_loc_w",
             "ray_max_far_dist", "shading_avg_color", "shading_avg_dir",
             "shading_avg_conf", "shading_avg_embedding")
EVAL_NERF = ("nerf_coarse_raycolor", "nerf_mass", "nerf_loc_w", "nerf_color")


def eval_fields(cfg: PointNeRFConfig, prob: bool) -> Tuple[str, ...]:
    fields = EVAL_CORE + (EVAL_PROB if prob else ())
    if cfg.render.fine_sample_num > 0 and not prob:
        fields += ("fine_raycolor",)
    if cfg.render.nerf_importance > 0:
        fields += EVAL_NERF
    return fields


def _gather_rays(out: RenderOutput, fields: Sequence[str],
                 mesh: Mesh) -> RenderOutput:
    """Every rank's block of `fields` gathered over the mesh in JAX's
    P(("dp", "mp")) order (global ray d * Rl + m * rs + i), packed into one
    float32 row per ray for one all_gather; the other fields None."""
    present = [f for f in fields if getattr(out, f) is not None]
    vals = [getattr(out, f) for f in present]
    rs = vals[0].shape[0]
    widths = [int(np.prod(v.shape[1:], dtype=np.int64)) for v in vals]
    packed = torch.cat([v.reshape(rs, -1).float() for v in vals], -1)
    full = all_gather(packed, mesh, ("dp", "mp"), 0)
    res = {f: None for f in RenderOutput._fields}
    for f, v, piece in zip(present, vals, full.split(widths, -1)):
        piece = piece.reshape((full.shape[0],) + tuple(v.shape[1:]))
        res[f] = piece > 0.5 if v.dtype == torch.bool else piece.to(v.dtype)
    return RenderOutput(**res)


def make_sharded_eval_step(cfg: PointNeRFConfig, mesh: Mesh,
                           prob: bool = False):
    """step(params, scene, batch) -> RenderOutput over the whole batch, on
    every rank (the ray axis re-assembled across (dp, mp)); with `prob` the
    probe outputs of point growing too. No jitter, no gradient."""
    fields = eval_fields(cfg, prob)

    @torch.inference_mode()
    def step(params, scene: ShardedScene, batch: RayBatch) -> RenderOutput:
        b = _dp_rows(batch, mesh)
        out, _gt = _render_local(params["mlp"], params["points"],
                                 _local_grid(scene), scene.Rw2c, b, cfg,
                                 mesh, train=False, prob=prob)
        return _gather_rays(out, fields, mesh)

    return step


def make_sharded_neural2d_step(cfg: PointNeRFConfig, mesh: Mesh, head,
                               patch: int):
    """step(state, scene, batch, gt_rgb [dp, patch, patch, 3], u=None) ->
    (state, items): the CNN head's training on the mesh. Each dp row renders
    one whole patch of patch^2 rays (the batch holds the dp patches one
    after another), each rank its patch^2 / mp block; the feature image is
    the blocks gathered over mp (a differentiable all_gather, whose
    transpose hands each rank the summed cotangent of its own block), laid
    out as [1, C, patch, patch] and decoded by the replicated head. The
    gradients are normalized as in `make_sharded_train_step`. Adam per
    group as `train/neural2d.make_neural2d_optimizer`."""
    from ..models.neural_render import apply_head
    from ..train.neural2d import (Neural2DState, _group_adam, _hwc,
                                  _value_and_grad as _n2d_value_and_grad,
                                  make_neural2d_optimizer)
    lrs = make_neural2d_optimizer(cfg)
    C = cfg.agg.shading_color_channel_num

    def step(state: Neural2DState, scene: ShardedScene, batch: RayBatch,
             gt_rgb: torch.Tensor, u: Optional[torch.Tensor] = None):
        b = _dp_rows(batch, mesh)
        grid = _local_grid(scene)
        gt = gt_rgb[mesh.d]

        def local_loss(p):
            pc_local = freeze_points(p["points"], cfg.points)
            out, _ = _render_local(p["mlp"], pc_local, grid, scene.Rw2c, b,
                                   cfg, mesh, train=True,
                                   generator=state.key, u=u)
            full = all_gather(out.coarse_raycolor, mesh, "mp", 0)
            feat_img = full.reshape(1, patch, patch, C).permute(0, 3, 1, 2)
            rgb = apply_head(head, p["head"], feat_img)
            loss = ((_hwc(rgb) - gt) ** 2).mean()
            return loss, {"loss_total": loss}

        _loss, items, grads = _n2d_value_and_grad(local_loss, state.params)
        grads = _normalize_grads(grads, mesh)
        items = pmean_items(items, mesh, ("dp", "mp"))
        items["psnr"] = mse2psnr(items["loss_total"])
        grads["points"] = apply_grad_flags(grads["points"], cfg.points)
        with torch.no_grad():
            updates, new_opt = _group_adam(grads, state.opt_state, lrs)
            new_params = tree_map(lambda p, du: p + du, state.params,
                                  updates)
        return Neural2DState(params=new_params, opt_state=new_opt,
                             step=state.step + 1, key=state.key), items

    return step


def _on(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def create_sharded_neural2d_state(generator: torch.Generator, agg_params,
                                  pc_local: PointCloud, head_params,
                                  scene: ShardedScene, cfg: PointNeRFConfig,
                                  mesh: Mesh):
    """Step-0 Neural2DState on the rank's device: the MLP and the head
    replicated, the rank's point shard, zero moments for every group.
    `generator` draws the jitter; seed it the same on every rank."""
    from ..train.neural2d import Neural2DState
    params = _on({"mlp": agg_params, "points": pc_local,
                  "head": head_params}, mesh.device)
    return Neural2DState(params=params,
                         opt_state=init_optimizer(params, tuple(params)),
                         step=torch.zeros((), dtype=torch.int32,
                                          device=mesh.device),
                         key=generator), scene


def sharded_prune(state: TrainState, scene: ShardedScene,
                  cfg: PointNeRFConfig, mesh: Mesh
                  ) -> Tuple[TrainState, ShardedScene, int]:
    """Confidence pruning of the sharded cloud: each rank packs its own
    shard's survivors (models/points.prune), the Adam moments are carried
    through the pack order with the dead tail zeroed (as the single-device
    apply_prune does), and the grids are rebuilt. Returns (state, scene,
    points kept over all shards)."""
    pc: PointCloud = state.params["points"]
    cap = pc.capacity
    pc2, _st2, kept, order = prune(
        pc, PointCloudStatic(num_active=scene.num_active[mesh.m],
                             Rw2c=scene.Rw2c),
        cfg.train.prune_thresh, return_order=True)
    num_active = all_gather(kept.reshape(1), mesh, "mp", 0)
    scene2 = build_sharded_scene(pc2, num_active, cfg, mesh, Rw2c=scene.Rw2c,
                                 max_d=scene.max_d)
    opt_state = _on(permute_point_opt_state(state.opt_state, order, kept,
                                            cap), mesh.device)
    new_state = TrainState(params=dict(state.params, points=pc2),
                           opt_state=opt_state, step=state.step,
                           key=state.key)
    return new_state, scene2, int(num_active.sum())


def sharded_grow(state: TrainState, scene: ShardedScene, cand,
                 cfg: PointNeRFConfig, mesh: Mesh
                 ) -> Tuple[TrainState, ShardedScene, int]:
    """Append probe candidates (`train/grow.ProbeCandidates`, the same on
    every rank) round-robin over the point shards, as partition_points
    deals them. When any shard would overflow, every shard moves to the
    same larger capacity first (its moments zero-padded); grown slots start
    with zero moments. Rebuilds the grids. Returns (state, scene, points
    added over all shards)."""
    pc: PointCloud = state.params["points"]
    opt_state = state.opt_state
    n_cand = cand.xyz.shape[0]
    mine = _shard_selections(n_cand, mesh.mp)[mesh.m]
    width = -(-n_cand // mesh.mp)
    cap = pc.capacity
    needed = int(scene.num_active.max()) + width
    if needed > cap:
        new_cap = round_capacity(needed)

        def repad(a, fill):
            return torch.cat([a, torch.full((new_cap - cap,) + a.shape[1:],
                                            fill, dtype=a.dtype,
                                            device=a.device)])
        pc = PointCloud(xyz=repad(pc.xyz, DEAD_XYZ),
                        features=repad(pc.features, 0.0),
                        conf=repad(pc.conf, 0.0), color=repad(pc.color, 0.0),
                        dirs=repad(pc.dirs, 0.0))
        opt_state = pad_point_opt_state(opt_state, cap, new_cap)
    n_local = scene.num_active[mesh.m]
    if width:
        dev = pc.xyz.device

        def pad_shard(a, fill):
            out = np.full((width,) + a.shape[1:], fill, np.float32)
            out[:len(mine)] = a[mine]
            return torch.from_numpy(out).to(dev)
        pc, st2, _added = grow(
            pc, PointCloudStatic(num_active=n_local, Rw2c=scene.Rw2c),
            pad_shard(cand.xyz, DEAD_XYZ), pad_shard(cand.embedding, 0.0),
            pad_shard(cand.conf, 0.0), pad_shard(cand.color, 0.0),
            pad_shard(cand.dirs, 0.0))
        n_local = st2.num_active
    num_active = all_gather(n_local.reshape(1).to(torch.int32), mesh, "mp", 0)
    scene2 = build_sharded_scene(pc, num_active, cfg, mesh, Rw2c=scene.Rw2c,
                                 max_d=scene.max_d)
    new_state = TrainState(params=dict(state.params, points=pc),
                           opt_state=_on(opt_state, mesh.device),
                           step=state.step, key=state.key)
    added = int(num_active.sum()) - int(scene.num_active.sum())
    return new_state, scene2, added


def create_sharded_train_state(generator: torch.Generator, agg_params,
                               pc_local: PointCloud, scene: ShardedScene,
                               cfg: PointNeRFConfig, mesh: Mesh
                               ) -> Tuple[TrainState, ShardedScene]:
    """Step-0 TrainState on the rank's device: the MLP replicated, the
    rank's point shard, zero Adam moments (the point moments the shard's).
    `generator` draws the jitter: seed it the same on every rank, as JAX
    replicates its key over the mesh."""
    params = _on({"mlp": agg_params, "points": pc_local}, mesh.device)
    return TrainState(params=params, opt_state=init_optimizer(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=mesh.device),
                      key=generator), scene


def gather_shards(state, mesh: Mesh):
    """The state with every shard's points and per-point moments gathered
    over mp into [mp, cap, ...] leaves (JAX's layout of a sharded state),
    on every rank; the replicated leaves as they are."""
    cap = state.params["points"].capacity

    def g(t):
        if _is_point_leaf(t, cap):
            return all_gather(t[None], mesh, "mp", 0)
        return t
    return state._replace(params=dict(state.params,
                                      points=tree_map(g, state.params[
                                          "points"])),
                          opt_state=tree_map(g, state.opt_state))
