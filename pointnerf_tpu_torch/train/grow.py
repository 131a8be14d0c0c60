"""Point pruning, probe-hole growth and gradient-driven splitting.

Counterpart of `pointnerf_tpu/train/grow.py`: `ProbeCandidates`,
`render_full_frame`, `_dilate3`, `accumulate_probe_candidates`,
`finalize_probe_candidates`, `probe_hole`, `permute_point_opt_state`,
`apply_prune`, `split_high_grad`, `pad_point_opt_state` and `apply_grow`.

- prune: drop points with conf <= prune_thresh, repack, and permute the
  per-point Adam moments and hit counters with the pack order;
- grow: render probe frames with the prob outputs, find rays that miss the
  cloud where the ground truth is not background, dilate that miss mask by
  one pixel, and add points at the neighboring hit rays' max-opacity sample
  locations with weight-averaged payloads (with nerf_create_points, also
  at the radiance field's expected location on missed rays where its blend
  mass is confident); grown slots start with zero moments, and the
  capacity moves to the next 4096-multiple when needed;
- split: clone the points whose payload-gradient EMA is large relative to
  how often they are sampled, a tangential step away.

Point leaves of the optimizer state are found by their leading dimension
being the capacity (at least 4096, wider than any MLP layer), as in JAX.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from ..config import PointNeRFConfig
from ..models.points import (DEAD_XYZ, PointCloud, PointCloudStatic, grow,
                             prune, round_capacity)
from ..models.renderer import RayBatch
from .optim import tree_map
from .step import TrainState, eval_step

PROBE_KEYS = ("coarse_raycolor", "ray_mask", "ray_max_sample_loc_w",
              "ray_max_far_dist", "ray_max_shading_opacity",
              "shading_avg_color", "shading_avg_dir", "shading_avg_conf",
              "shading_avg_embedding")
# the hybrid's creation signals, probed when nerf_importance > 0
NERF_PROBE_KEYS = ("nerf_mass", "nerf_loc_w", "nerf_color")


class ProbeCandidates(NamedTuple):
    xyz: np.ndarray        # [M, 3]
    embedding: np.ndarray  # [M, F]
    color: np.ndarray      # [M, 3]
    dirs: np.ndarray       # [M, 3]
    conf: np.ndarray       # [M, 1]


def render_full_frame(params, st: PointCloudStatic, grid,
                      cfg: PointNeRFConfig, item: Dict,
                      wh: Tuple[int, int], chunk: int = 2304,
                      prob: bool = True) -> Dict[str, np.ndarray]:
    """Render every ray of `item` in chunks of `chunk` rays (the last one
    padded with zero directions) and assemble H x W maps of the outputs:
    the probe fields with `prob`, else the color and the ray mask. Each
    chunk's fields are copied to the host before the next chunk renders."""
    W, H = wh
    dev = params["points"].xyz.device
    raydir = np.asarray(item["raydir"], np.float32)
    pix = np.asarray(item["pixel_idx"], np.int64)
    keys = PROBE_KEYS if prob else ("coarse_raycolor", "ray_mask")
    if prob and cfg.render.nerf_importance > 0:
        keys = keys + NERF_PROBE_KEYS

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)
    campos, camrot = t(item["campos"]), t(item["camrotc2w"])
    near, far = t(cfg.render.near_plane), t(cfg.render.far_plane)
    zero_pix = torch.zeros((chunk, 2), dtype=torch.int32, device=dev)
    maps: Dict[str, np.ndarray] = {}
    for s in range(0, raydir.shape[0], chunk):
        rd = raydir[s:s + chunk]
        n = rd.shape[0]
        if n < chunk:
            rd = np.concatenate([rd, np.zeros((chunk - n, 3), np.float32)])
        batch = RayBatch(campos=campos, camrotc2w=camrot, raydir=t(rd),
                         pixel_idx=zero_pix, near=near, far=far)
        out = eval_step(params, st, grid, batch, cfg, prob=prob)
        vals = {k: getattr(out, k)[:n].cpu().numpy() for k in keys}
        del out
        px, py = pix[s:s + n, 0], pix[s:s + n, 1]
        for k, v in vals.items():
            if v.ndim == 1:
                v = v[:, None]
            if k not in maps:
                maps[k] = np.zeros((H, W, v.shape[-1]), v.dtype)
            maps[k][py, px] = v
    return maps


def _dilate3(mask: np.ndarray) -> np.ndarray:
    """3x3 binary dilation (wrapping at the image border, as in JAX)."""
    out = mask.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out |= np.roll(np.roll(mask, dy, axis=0), dx, axis=1)
    return out


def accumulate_probe_candidates(adds: Dict, maps: Dict, item: Dict,
                                cfg: PointNeRFConfig, wh: Tuple[int, int],
                                bg: np.ndarray):
    """One probe frame's grow candidates: hit rays next to a missed ray
    whose ground truth is not background, where the peak opacity exceeds
    prob_thresh; with nerf_create_points also the missed rays whose field
    mass exceeds it."""
    W, H = wh
    gt = np.zeros((H, W, 3), np.float32)
    pix = np.asarray(item["pixel_idx"], np.int64)
    gt[pix[:, 1], pix[:, 0]] = np.asarray(item["gt_image"], np.float32)
    ray_mask = maps["ray_mask"][..., 0] > 0
    miss = (~ray_mask) & (np.linalg.norm(gt - bg, axis=-1) > 0.002)
    sel = (ray_mask & _dilate3(miss)
           & (maps["ray_max_shading_opacity"][..., 0]
              > cfg.train.prob_thresh))
    if sel.any():
        adds["xyz"].append(maps["ray_max_sample_loc_w"][sel])
        adds["embedding"].append(maps["shading_avg_embedding"][sel])
        adds["color"].append(maps["shading_avg_color"][sel])
        adds["dirs"].append(maps["shading_avg_dir"][sel])
        adds["conf"].append(maps["shading_avg_conf"][sel]
                            * cfg.train.prob_mul)
    # NeRF-driven creation: missed rays where the radiance field carries
    # blend mass above prob_thresh get a point at the field's expected
    # location — where no point geometry is near at all
    if (cfg.train.nerf_create_points and "nerf_mass" in maps
            and maps.get("nerf_color") is not None
            and maps["nerf_color"].shape[-1] == 3):
        seln = miss & (maps["nerf_mass"][..., 0] > cfg.train.prob_thresh)
        if seln.any():
            n = int(seln.sum())
            adds["xyz"].append(maps["nerf_loc_w"][seln])
            # the field has no embedding to give: small noise, drawn as the
            # JAX package draws it
            rng = np.random.RandomState(n)
            F = cfg.agg.point_features_dim
            adds["embedding"].append(
                rng.randn(n, F).astype(np.float32) * 0.01)
            adds["color"].append(maps["nerf_color"][seln])
            # facing the camera: -raydir at those pixels
            rd = np.zeros((H, W, 3), np.float32)
            rd[pix[:, 1], pix[:, 0]] = np.asarray(item["raydir"], np.float32)
            d = -rd[seln]
            d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-8)
            adds["dirs"].append(d)
            adds["conf"].append(maps["nerf_mass"][seln] * cfg.train.prob_mul)


def finalize_probe_candidates(adds: Dict, cfg: PointNeRFConfig
                              ) -> ProbeCandidates:
    def cat(k, d):
        return (np.concatenate(adds[k]).astype(np.float32) if adds[k]
                else np.zeros((0, d), np.float32))
    F = cfg.agg.point_features_dim
    return ProbeCandidates(xyz=cat("xyz", 3), embedding=cat("embedding", F),
                           color=cat("color", 3), dirs=cat("dirs", 3),
                           conf=cat("conf", 1))


def probe_hole(params, st: PointCloudStatic, grid, cfg: PointNeRFConfig,
               items: List[Dict], wh: Tuple[int, int], bg_color=None,
               chunk: int = 2304) -> ProbeCandidates:
    """Scan probe frames for holes (and, with nerf_create_points, for the
    field's confident mass on missed rays); returns the grow candidates."""
    bg = np.asarray(bg_color if bg_color is not None else cfg.render.bg_color,
                    np.float32)
    adds = {k: [] for k in ("xyz", "embedding", "color", "dirs", "conf")}
    for item in items:
        maps = render_full_frame(params, st, grid, cfg, item, wh, chunk,
                                 prob=True)
        accumulate_probe_candidates(adds, maps, item, cfg, wh, bg)
    return finalize_probe_candidates(adds, cfg)


def _is_point_leaf(x, capacity: int) -> bool:
    return torch.is_tensor(x) and x.dim() >= 1 and x.shape[0] == capacity


def permute_point_opt_state(opt_state, order, kept, capacity: int):
    """Carry Adam moments through a prune repack: permute the per-point rows
    with the pack order and zero the dead tail."""
    dead = torch.arange(capacity, device=order.device) >= kept

    def visit(x):
        if not _is_point_leaf(x, capacity):
            return x
        d = dead.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(d, torch.zeros((), dtype=x.dtype,
                                          device=x.device), x[order])
    return tree_map(visit, opt_state)


def apply_prune(state: TrainState, st: PointCloudStatic,
                cfg: PointNeRFConfig
                ) -> Tuple[TrainState, PointCloudStatic, int]:
    """Drop conf <= prune_thresh points and repack, permuting the Adam
    moments and hit counters along. With prune_min_hits > 0, points with
    fewer cumulative neighbor hits are exempt (under-trained, not
    misplaced)."""
    protect = None
    if cfg.train.prune_min_hits > 0 and state.hits is not None:
        protect = state.hits[:, 0] < cfg.train.prune_min_hits
    pc2, st2, kept, order = prune(state.params["points"], st,
                                  cfg.train.prune_thresh, return_order=True,
                                  protect=protect)
    opt_state = permute_point_opt_state(state.opt_state, order, kept,
                                        pc2.capacity)
    hits = state.hits
    if hits is not None:
        live = (torch.arange(pc2.capacity, device=hits.device) < kept)
        hits = torch.where(live[:, None], hits[order],
                           torch.zeros((), device=hits.device))
    return (state._replace(params=dict(state.params, points=pc2),
                           opt_state=opt_state, hits=hits), st2, int(kept))


def split_high_grad(state: TrainState, st: PointCloudStatic,
                    cfg: PointNeRFConfig
                    ) -> Tuple[TrainState, PointCloudStatic, int]:
    """Clone the `split_top` points of largest score = grad_ema /
    (hit_ema + 1). Offspring inherit the parent's payload and land a
    tangential `split_jitter * vsize` step away (perpendicular to the
    parent's dir), drawn from np.random.RandomState(step) as in JAX; they
    start with zero moments and counters, and the parents' gradient EMA is
    reset."""
    t = cfg.train
    if state.hits is None or state.hits.shape[1] < 3 or t.split_top <= 0:
        return state, st, 0
    pc: PointCloud = state.params["points"]
    n_act = int(st.num_active)
    hits = state.hits.cpu().numpy()
    score = hits[:n_act, 2] / (hits[:n_act, 1] + 1.0)
    n = min(t.split_top, n_act)
    parents = np.argsort(-score)[:n]
    parents = parents[score[parents] > 0.0]
    if parents.size == 0:
        return state, st, 0

    rng = np.random.RandomState(int(state.step) & 0x7FFFFFFF)
    pidx = torch.from_numpy(parents).to(pc.xyz.device)

    def rows(a):
        return a[pidx].cpu().numpy()
    pxyz, pdir = rows(pc.xyz), rows(pc.dirs)
    nrm = pdir / np.maximum(np.linalg.norm(pdir, axis=-1, keepdims=True),
                            1e-8)
    r = rng.randn(parents.size, 3).astype(np.float32)
    tang = r - np.sum(r * nrm, axis=-1, keepdims=True) * nrm
    tl = np.linalg.norm(tang, axis=-1, keepdims=True)
    # degenerate (r parallel to the dir, or a zero dir): r itself
    tang = np.where(tl > 1e-6, tang / np.maximum(tl, 1e-8),
                    r / np.maximum(np.linalg.norm(r, axis=-1,
                                                  keepdims=True), 1e-8))
    step_len = t.split_jitter * float(max(cfg.query.vsize[0],
                                          cfg.query.vsize[1]))
    cand = ProbeCandidates(
        xyz=(pxyz + tang * step_len).astype(np.float32),
        embedding=rows(pc.features), color=rows(pc.color), dirs=pdir,
        conf=rows(pc.conf))
    state, st, added = apply_grow(state, st, cand, cfg)
    if added and state.hits is not None:
        hits = state.hits.clone()
        hits[pidx, 2] = 0.0
        state = state._replace(hits=hits)
    return state, st, added


def pad_point_opt_state(opt_state, old_cap: int, new_cap: int):
    """Zero-pad per-point Adam moments to a larger capacity (the new slots
    had no gradient, so zero moments are exact)."""
    def visit(x):
        if not _is_point_leaf(x, old_cap):
            return x
        return torch.cat([x, x.new_zeros((new_cap - old_cap,) + x.shape[1:])])
    return tree_map(visit, opt_state)


def apply_grow(state: TrainState, st: PointCloudStatic,
               cand: ProbeCandidates, cfg: PointNeRFConfig
               ) -> Tuple[TrainState, PointCloudStatic, int]:
    """Append candidates, moving to the next capacity bucket when they do
    not fit. Grown slots start with zero moments and zero hit counters."""
    pc: PointCloud = state.params["points"]
    opt_state, hits = state.opt_state, state.hits
    n_new = cand.xyz.shape[0]
    needed = int(st.num_active) + n_new
    if needed > pc.capacity:
        old_cap, new_cap = pc.capacity, round_capacity(needed)

        def repad(a, fill):
            return torch.cat([a, torch.full((new_cap - old_cap,) + a.shape[1:],
                                            fill, dtype=a.dtype,
                                            device=a.device)])
        pc = PointCloud(xyz=repad(pc.xyz, DEAD_XYZ),
                        features=repad(pc.features, 0.0),
                        conf=repad(pc.conf, 0.0), color=repad(pc.color, 0.0),
                        dirs=repad(pc.dirs, 0.0))
        opt_state = pad_point_opt_state(opt_state, old_cap, new_cap)
        if hits is not None:
            hits = repad(hits, 0.0)
    added = 0
    if n_new:
        dev = pc.xyz.device

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
        pc, st, added_t = grow(pc, st, t(cand.xyz), t(cand.embedding),
                               t(cand.conf), t(cand.color), t(cand.dirs))
        added = int(added_t)
    return (state._replace(params=dict(state.params, points=pc),
                           opt_state=opt_state, hits=hits), st, added)
