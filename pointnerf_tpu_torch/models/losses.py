"""Loss engine.

Counterpart of `pointnerf_tpu/models/losses.py` (`compute_losses`,
`mse2psnr`), itself the masked-static form of the reference
BaseRenderingModel.compute_losses. Name-prefix dispatch: `ray_masked_X`
restricts the L2 to rays the query hit, `ray_miss_X` to missed rays
(weighted by the miss count), plain names use all rays; each colour item
adds 1e-6 to the total. Depth (`ray_depth_masked_coarse_depth`), background
(`coarse_is_background`), the zero-one regulariser on `conf_coefficient`
(masked to valid neighbor slots, as in JAX) and the sparse loss follow.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import LossConfig
from .renderer import RenderOutput


def _masked_mse(pred, gt, mask):
    """Mean squared error over rows where mask is True (rows are [..., C])."""
    m = mask.to(pred.dtype)[..., None]
    num = m.sum() * pred.shape[-1]
    return (m * (pred - gt) ** 2).sum() / num.clamp(min=1.0)


def compute_losses(out: RenderOutput, gt_image: torch.Tensor,
                   cfg: LossConfig, gt_depth: Optional[torch.Tensor] = None,
                   bg_color: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (total_loss, per-item dict). gt_image [R, 3]; gt_depth
    (optional) [R] or [R, 1] for depth_loss_items; bg_color (optional) [3]
    for bg_loss_items. The port renders the coarse pass only, so the colour
    items read `coarse_raycolor`."""
    total = torch.zeros((), device=gt_image.device)
    items: Dict[str, torch.Tensor] = {}
    output = {"coarse_raycolor": out.coarse_raycolor}

    for name, wgt in zip(cfg.color_loss_items, cfg.color_loss_weights):
        if name.startswith("ray_masked_"):
            loss = _masked_mse(output[name[len("ray_masked_"):]], gt_image,
                               out.ray_mask)
        elif name.startswith("ray_miss_"):
            miss = ~out.ray_mask
            # the reference multiplies the mean by the miss count
            loss = _masked_mse(output[name[len("ray_miss_"):]], gt_image,
                               miss) * miss.float().sum()
        else:
            loss = ((output[name] - gt_image) ** 2).mean()
        items["loss_" + name] = loss
        total = total + loss * wgt + 1e-6

    if gt_depth is not None:
        gt_d = gt_depth.reshape(-1, 1)
        for name, wgt in zip(cfg.depth_loss_items, cfg.depth_loss_weights):
            base = (name[len("ray_depth_masked_"):]
                    if name.startswith("ray_depth_masked_") else name)
            if base != "coarse_depth":
                raise ValueError(f"unknown depth loss item {name!r}")
            m = out.ray_mask & (gt_d[:, 0] > 0)
            loss = _masked_mse(out.coarse_depth, gt_d, m)
            items["loss_" + name] = loss
            total = total + loss * wgt

    if bg_color is not None and cfg.bg_loss_items:
        is_bg = (torch.linalg.norm(gt_image - bg_color.reshape(1, -1), dim=-1)
                 < cfg.bg_color_match_eps).float()[:, None]
        for name, wgt in zip(cfg.bg_loss_items, cfg.bg_loss_weights):
            if name != "coarse_is_background":
                raise ValueError(f"unknown background loss item {name!r}")
            loss = ((out.coarse_is_background - is_bg) ** 2).mean()
            items["loss_" + name] = loss
            total = total + loss * wgt

    for name, wgt in zip(cfg.zero_one_loss_items, cfg.zero_one_loss_weights):
        if name == "conf_coefficient":
            val = out.conf_coefficient.clamp(cfg.zero_epsilon,
                                             1.0 - cfg.zero_epsilon)
            vf = (out.ray_valid[..., None] & (out.weight > 0)).to(val.dtype)
            loss = (vf * (torch.log(val) + torch.log(1.0 - val))).sum() \
                / vf.sum().clamp(min=1.0)
            items["loss_" + name] = loss
            total = total + loss * wgt

    if cfg.sparse_loss_weight > 0:
        w = out.weight
        loss = (w * (1.0 - torch.exp(-2.0 * out.conf_coefficient)).abs()
                ).sum() / (w.sum() + 1e-6)
        items["loss_sparse"] = loss
        total = total + loss * cfg.sparse_loss_weight

    return total, items


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(mse.clamp(min=1e-10))
