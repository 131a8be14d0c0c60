"""Feed-forward (generalization) training: every batch builds a fresh
neural point cloud from MVSNet depth and 2D features, renders training rays
against it, and backpropagates the pixel loss into both the shading MLPs
and the MVS networks.

Counterpart of `pointnerf_tpu/train/feedforward.py` (`MVSBatch`, `FFState`,
`make_ff_optimizer`, `points_from_depth`, `make_feedforward_step` with its
`gen_cloud` / `loss_fn` / `step` / `infer_cloud`, `create_ff_state`). Every
1/4-resolution reference pixel becomes a point; the cloud is padded to
`capacity` with xyz = 1e8 as in JAX. The grid is built on the detached xyz
(its indices are discrete); the gradient reaches xyz, and through it the
depth map and MVSNet, via the payload gather and the perspective
coordinates. Two Adam groups, "mlp" and "mvs", both at cfg.train.lr, with
the alternation of `train/optim.alternated_update`; the BatchNorm running
stats are a third state beside them (`FFState.mvs_stats`). The MVS
convolutions run in float32 forward and backward (`mvsnet.mvs_precision`).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..config import PointNeRFConfig
from ..models.losses import compute_losses, mse2psnr
from ..models.points import PointCloud, PointCloudStatic
from ..models.renderer import RayBatch, render_rays
from ..mvs.mvsnet import mvs_precision
from ..mvs.points_init import MvsPointsInit, mvs_apply
from ..ops.grid import build_grid
from .optim import (AdamState, alternated_update, init_optimizer,
                    lr_schedule, tree_leaves, tree_map)

FF_GROUPS = ("mlp", "mvs")
PAD_XYZ = 1.0e8


class MVSBatch(NamedTuple):
    """One generalization-training sample: V source views + target rays."""
    images: torch.Tensor        # [V, 3, H, W]
    proj_mats: torch.Tensor     # [V, 4, 4] plane-sweep projections
    Ks: torch.Tensor            # [V, 3, 3]
    w2cs: torch.Tensor          # [V, 4, 4]
    depth_values: torch.Tensor  # [D]
    rays: RayBatch              # target-view rays (with gt)


class FFState(NamedTuple):
    params: Dict[str, Any]      # {"mvs": {name: tensor}, "mlp": aggregator}
    opt_state: Dict[str, AdamState]
    step: torch.Tensor          # [] int32
    key: torch.Generator        # draws the ray-sample jitter
    mvs_stats: Dict[str, torch.Tensor]   # BatchNorm running stats


def make_ff_optimizer(cfg: PointNeRFConfig) -> Dict[str, Any]:
    """The two groups' learning rates: the render MLPs and the MVS nets
    both at cfg.train.lr on its schedule."""
    return {"mlp": lr_schedule(cfg.train.lr, cfg),
            "mvs": lr_schedule(cfg.train.lr, cfg)}


def points_from_depth(depth: torch.Tensor, K_quarter: torch.Tensor,
                      c2w_ref: torch.Tensor) -> torch.Tensor:
    """Every 1/4-resolution pixel lifted to a world point: [h*w, 3]."""
    h, w = depth.shape
    dev = depth.device
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                          torch.arange(w, dtype=torch.float32, device=dev),
                          indexing="ij")
    pix = torch.stack([x, y, torch.ones_like(x)], 0).reshape(3, -1)
    cam = torch.linalg.inv(K_quarter) @ (pix * depth.reshape(1, -1))
    cam_h = torch.cat([cam, torch.ones((1, cam.shape[1]), device=dev)], 0)
    return (c2w_ref @ cam_h)[:3].T


def gen_cloud(model: MvsPointsInit, capacity: int, mvs_params, mvs_stats,
              batch: MVSBatch, train: bool):
    """MVSNet on the batch's views, every reference pixel lifted and
    embedded, padded to `capacity`. Returns (pc, st, new_stats): in train
    mode the BatchNorm normalizes with batch statistics and new_stats are
    the updated running stats (copies; `mvs_stats` is left as it was)."""
    stats = ({k: v.clone() for k, v in mvs_stats.items()} if train
             else mvs_stats)
    variables = {"params": mvs_params, "batch_stats": stats}
    depth, conf, feats, _prob = mvs_apply(
        model, variables, batch.images, batch.proj_mats, batch.depth_values,
        train, method="depth_one_view")
    H = batch.images.shape[2]
    h = depth.shape[0]
    Kq = batch.Ks[0] * (h / H)
    Kq[2, 2] = 1.0
    c2w_ref = torch.linalg.inv(batch.w2cs[0])
    xyz = points_from_depth(depth, Kq, c2w_ref)
    conf_pts = conf.reshape(-1, 1)
    campos_ref = c2w_ref[:3, 3]
    emb, color, dirs, conf_pts = mvs_apply(
        model, variables, xyz, batch.images, feats, batch.Ks, batch.w2cs,
        campos_ref, conf_pts, method="embed_points")
    n = xyz.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points > capacity {capacity}")
    pad = capacity - n

    def p(a, fill=0.0):
        return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), fill,
                                        dtype=a.dtype, device=a.device)])
    pc = PointCloud(xyz=p(xyz, PAD_XYZ), features=p(emb), conf=p(conf_pts),
                    color=p(color), dirs=p(dirs))
    st = PointCloudStatic(
        num_active=torch.tensor(n, dtype=torch.int32, device=xyz.device),
        Rw2c=torch.eye(3, device=xyz.device))
    return pc, st, stats


def ff_loss_and_grads(cfg: PointNeRFConfig, model: MvsPointsInit,
                      capacity: int, params, mvs_stats, batch: MVSBatch,
                      generator: Optional[torch.Generator] = None,
                      u: Optional[torch.Tensor] = None):
    """The step's loss (train-mode MVSNet, the cloud, the training render)
    and its gradients with respect to both groups. The ray jitter is `u`
    [R, D] if given, else drawn from `generator`. Returns (total, items,
    grads, new_stats), grads in the layout of `params` (zeros where none
    flows)."""
    if torch.is_inference_mode_enabled():
        raise RuntimeError("training needs autograd: do not call it under "
                           "torch.inference_mode")
    params = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad(), mvs_precision():
        pc, st, new_stats = gen_cloud(model, capacity, params["mvs"],
                                      mvs_stats, batch, train=True)
        grid = build_grid(pc.xyz.detach(), st.num_active, cfg.query)
        out = render_rays(params["mlp"], pc, st, grid, batch.rays, cfg,
                          train=True, generator=generator, u=u)
        gt = batch.rays.gt_image
        total, items = compute_losses(out, gt, cfg.loss)
        items["psnr"] = mse2psnr(((out.coarse_raycolor - gt) ** 2).mean())
        leaves = tree_leaves(params)
        gl = torch.autograd.grad(total, leaves, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, gl)])
    items = {k: v.detach() for k, v in items.items()}
    items["loss_total"] = total.detach()
    return (total.detach(), items, tree_map(lambda _p: next(it), params),
            {k: v.detach() for k, v in new_stats.items()})


def make_feedforward_step(cfg: PointNeRFConfig, model: MvsPointsInit,
                          capacity: int):
    """(step, infer_cloud). step(state, batch, u=None) -> (state, items)
    takes one end-to-end step; infer_cloud(params, mvs_stats, batch) ->
    (pc, st) builds a cloud for a new scene with eval-mode BatchNorm.
    `capacity` must cover h*w points."""
    lrs = make_ff_optimizer(cfg)

    def step(state: FFState, batch: MVSBatch,
             u: Optional[torch.Tensor] = None) -> Tuple[FFState, Dict]:
        _total, items, grads, new_stats = ff_loss_and_grads(
            cfg, model, capacity, state.params, state.mvs_stats, batch,
            generator=state.key, u=u)
        with torch.no_grad():
            updates, new_opt = alternated_update(
                grads, state.opt_state, state.step, cfg.train.alter_step,
                cfg, lrs=lrs)
            new_params = tree_map(lambda p, du: p + du, state.params,
                                  updates)
        return FFState(params=new_params, opt_state=new_opt,
                       step=state.step + 1, key=state.key,
                       mvs_stats=new_stats), items

    @torch.no_grad()
    def infer_cloud(params, mvs_stats, batch: MVSBatch):
        """Zero-shot point-cloud generation for a new scene."""
        pc, st, _ = gen_cloud(model, capacity, params["mvs"], mvs_stats,
                              batch, train=False)
        return pc, st

    return step, infer_cloud


def create_ff_state(generator: torch.Generator, mvs_variables: Dict,
                    agg_params, cfg: PointNeRFConfig) -> FFState:
    """Step-0 state. mvs_variables: {"params", "batch_stats"} of the
    MvsPointsInit (`init_mvs_points`, or JAX's through
    `convert.mvs_variables_from_jax`); `generator` draws the jitter on the
    device of the batches."""
    params = {"mvs": dict(mvs_variables["params"]), "mlp": agg_params}
    stats = dict(mvs_variables.get("batch_stats") or {})
    dev = next(iter(params["mvs"].values())).device
    return FFState(params=params,
                   opt_state=init_optimizer(params, groups=FF_GROUPS),
                   step=torch.zeros((), dtype=torch.int32, device=dev),
                   key=generator, mvs_stats=stats)
