"""The training step, the inference step and the grid refresh.

Counterpart of `pointnerf_tpu/train/step.py`: `TrainState`,
`create_train_state`, `loss_fn`, `train_step` (render -> loss -> gradients
-> two-group Adam step), `eval_step` and `refresh_grid`. PyTorch runs
eagerly, so nothing here is compiled; `train_step` returns a new state and
leaves the old one's tensors as they were, as the JAX step does (the
jitter generator in `key` is shared and advances).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..config import PointNeRFConfig, hits_tracked
from ..models.losses import compute_losses, mse2psnr
from ..models.points import PointCloud, PointCloudStatic
from ..models.renderer import (RayBatch, RenderOutput, check_knn_envelope,
                               render_rays)
from ..ops.grid import PointGrid, build_grid
from .optim import (AdamState, alternated_update, apply_grad_flags,
                    freeze_points, hit_boost, init_optimizer, tree_leaves,
                    tree_map)


class TrainState(NamedTuple):
    params: Dict[str, Any]        # {"mlp": aggregator params, "points": PointCloud}
    opt_state: Dict[str, AdamState]
    step: torch.Tensor            # [] int32
    key: torch.Generator          # draws the ray-sample jitter
    # per-point counters [capacity, 3]: cumulative neighbor hits, hit EMA,
    # payload gradient-norm EMA (see the JAX TrainState)
    hits: Optional[torch.Tensor] = None


def create_train_state(generator: torch.Generator, agg_params,
                       pc: PointCloud, cfg: PointNeRFConfig) -> TrainState:
    """Step-0 state. `generator` lives on the device of the batches it will
    jitter."""
    params = {"mlp": agg_params, "points": pc}
    return TrainState(params=params, opt_state=init_optimizer(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=pc.xyz.device),
                      key=generator,
                      hits=torch.zeros((pc.capacity, 3), device=pc.xyz.device))


def loss_fn(params, st: PointCloudStatic, grid: PointGrid, batch: RayBatch,
            cfg: PointNeRFConfig, generator: Optional[torch.Generator] = None,
            u: Optional[torch.Tensor] = None,
            compute_dtype=torch.float32,
            draws: Optional[Dict[str, torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Training render + losses. Returns (total, items); items carry
    psnr, psnr_masked, n_miss, n_decode_dropped, per_ray_err and, when
    `hits_tracked(cfg)`, the per-point neighbor-hit increment hit_inc (the
    coarse and the fine pass's neighbors). `u` and `draws` are
    `render_rays`'."""
    pc = freeze_points(params["points"], cfg.points)
    out = render_rays(params["mlp"], pc, st, grid, batch, cfg, train=True,
                      compute_dtype=compute_dtype, generator=generator, u=u,
                      draws=draws)
    gt = batch.gt_image
    total, items = compute_losses(out, gt, cfg.loss)
    zero = torch.zeros((), device=gt.device)
    items["psnr_masked"] = mse2psnr(items.get(
        "loss_ray_masked_coarse_raycolor", zero))
    items["psnr"] = mse2psnr(((out.coarse_raycolor - gt) ** 2).mean())
    # misses whose ground truth is not background (the probe criterion)
    miss = ~out.ray_mask
    if gt.shape[-1] == 3:
        bg = torch.tensor(cfg.render.bg_color, dtype=torch.float32,
                          device=gt.device)
        miss = miss & (torch.linalg.norm(gt - bg[None], dim=-1) > 2e-3)
    items["n_miss"] = miss.sum().to(torch.int32)
    if out.decode_dropped is not None:
        items["n_decode_dropped"] = out.decode_dropped
    items["per_ray_err"] = ((out.coarse_raycolor - gt) ** 2).mean(-1).detach()
    if hits_tracked(cfg):
        cap = params["points"].capacity
        flat = torch.cat([p.reshape(-1) for p in (out.neighbor_pidx,
                                                  out.fine_neighbor_pidx)
                          if p is not None]).long()
        flat = flat[flat >= 0]
        items["hit_inc"] = torch.zeros(cap, device=gt.device).index_add_(
            0, flat, torch.ones(flat.shape, device=gt.device))
    return total, items


def loss_and_grads(params, st: PointCloudStatic, grid: PointGrid,
                   batch: RayBatch, cfg: PointNeRFConfig,
                   generator: Optional[torch.Generator] = None,
                   u: Optional[torch.Tensor] = None,
                   draws: Optional[Dict[str, torch.Tensor]] = None):
    """(total, items, grads): `loss_fn` and the gradient of its total with
    respect to every parameter (zeros where none flows), in the layout of
    `params`, before the grad flags."""
    if torch.is_inference_mode_enabled():
        raise RuntimeError("training needs autograd: do not call it under "
                           "torch.inference_mode")
    params = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        total, items = loss_fn(params, st, grid, batch, cfg,
                               generator=generator, u=u, draws=draws)
        leaves = tree_leaves(params)
        gl = torch.autograd.grad(total, leaves, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, gl)])
    items = {k: v.detach() for k, v in items.items()}
    items["loss_total"] = total.detach()
    return total.detach(), items, tree_map(lambda _p: next(it), params)


def train_step(state: TrainState, st: PointCloudStatic, grid: PointGrid,
               batch: RayBatch, cfg: PointNeRFConfig,
               u: Optional[torch.Tensor] = None,
               draws: Optional[Dict[str, torch.Tensor]] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimization step on a batch of rays: render, losses, gradients
    of every parameter (flags applied), the two-group Adam update (with the
    alternation and the hit boost), the hit counters. The random draws come
    from `state.key` unless given: `u` [R, D] the coarse jitter, `draws`
    the fine pass's and the hybrid's (`render_rays`; parity tests pass
    JAX's). Must not run under `torch.inference_mode`."""
    _total, items, grads = loss_and_grads(state.params, st, grid, batch, cfg,
                                          generator=state.key, u=u,
                                          draws=draws)
    grads["points"] = apply_grad_flags(grads["points"], cfg.points)

    with torch.no_grad():
        updates, new_opt = alternated_update(grads, state.opt_state,
                                             state.step, cfg.train.alter_step,
                                             cfg)
        hit_inc = items.pop("hit_inc", None)
        new_hits = state.hits
        if state.hits is not None and hit_inc is not None:
            d = cfg.train.hit_ema_decay
            # per-point payload gradient norm (post grad flags, pre boost)
            gpt = grads["points"]
            gnorm = torch.sqrt((gpt.features ** 2).sum(-1)
                               + (gpt.color ** 2).sum(-1)
                               + (gpt.conf ** 2).sum(-1)
                               + (gpt.xyz ** 2).sum(-1))
            h = state.hits
            new_hits = torch.stack([h[:, 0] + hit_inc,
                                    h[:, 1] * d + hit_inc * (1.0 - d),
                                    h[:, 2] * d + gnorm * (1.0 - d)], -1)
            if cfg.train.hit_lr_boost > 1.0:
                # under-hit payloads move faster (pre-update EMA)
                boost = hit_boost(h[:, 1], cfg.train.hit_lr_boost,
                                  cfg.train.hit_boost_pow)[:, None]
                p = updates["points"]
                updates["points"] = p._replace(
                    features=p.features * boost, color=p.color * boost,
                    dirs=p.dirs * boost, conf=p.conf * boost)
        new_params = tree_map(lambda p, du: p + du, state.params, updates)
    return TrainState(params=new_params, opt_state=new_opt,
                      step=state.step + 1, key=state.key,
                      hits=new_hits), items


@torch.inference_mode()
def eval_step(params, st: PointCloudStatic, grid: PointGrid, batch: RayBatch,
              cfg: PointNeRFConfig, prob: bool = False) -> RenderOutput:
    """Inference forward (no jitter, no grad). params = {"mlp": aggregator
    params, "points": PointCloud}; everything on one device."""
    return render_rays(params["mlp"], params["points"], st, grid, batch, cfg,
                       train=False, prob=prob)


def refresh_grid(pc: PointCloud, st: PointCloudStatic, cfg: PointNeRFConfig,
                 max_d: Optional[int] = None) -> Tuple[PointGrid, int]:
    """Rebuild the occupancy grid and neighbor tables after a point-set
    change. Returns (grid, max_d).

    Truncation guard: when the true dilated-occupied cell count exceeds the
    table capacity, the grid is rebuilt with max_d auto-sized to 1.25x that
    count (rounded up to 4096) — never silently truncated. The max_d used is
    handed back; pass it as `max_d` to later refreshes so they build once
    (the JAX version rebuilds twice on every refresh past the envelope).
    On the card a query past K1's limits is refused before the build."""
    check_knn_envelope(cfg.query, pc.xyz.device)
    q = cfg.query if max_d is None else dataclasses.replace(cfg.query,
                                                            max_d=max_d)
    grid = build_grid(pc.xyz, st.num_active, q)
    nd = int(grid.num_dil)
    caps = [grid.occ_vids.shape[0]]
    if grid.nbr_pid is not None:
        caps.append(grid.nbr_pid.shape[0])
    if nd > min(caps):
        new_max_d = -(-int(nd * 1.25) // 4096) * 4096
        print(f"[grid] {nd} dilated-occupied cells exceed the table "
              f"envelope {min(caps)}; rebuilding with max_d={new_max_d}")
        q = dataclasses.replace(q, max_d=new_max_d)
        grid = build_grid(pc.xyz, st.num_active, q)
    return grid, q.max_d
