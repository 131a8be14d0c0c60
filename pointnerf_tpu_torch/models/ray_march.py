"""Ray marching + render/blend/tonemap registries.

Counterpart of `pointnerf_tpu/models/ray_march.py` (`ray_march`,
`radiance_render`, `alpha_blend`, `RENDER_FUNCS`, `BLEND_FUNCS`,
`TONEMAP_FUNCS`). This is the plain compositor; kernel K2
(`ops/fused_march.py`) computes the radiance/alpha case in one pass.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


def radiance_render(ray_feature):
    return ray_feature[..., 1:]


def white_color(ray_feature):
    return torch.ones_like(ray_feature[..., 1:4])


RENDER_FUNCS: Dict[str, Callable] = {"radiance": radiance_render,
                                     "white": white_color}


def alpha_blend(opacity, acc_transmission):
    return opacity * acc_transmission


def alpha2_blend(opacity, acc_transmission):
    return opacity * acc_transmission * acc_transmission


BLEND_FUNCS: Dict[str, Callable] = {"alpha": alpha_blend,
                                    "alpha2": alpha2_blend}


def simple_tone_map(color, gamma=2.2, exposure=1.0):
    return torch.clamp(torch.pow(color * exposure + 1e-5, 1.0 / gamma),
                       0.0, 1.0)


def no_tone_map(color):
    return color


def normalize_tone_map(color):
    color = color / torch.linalg.norm(color, dim=-1, keepdim=True).clamp(
        min=1e-12)
    return color * 0.5 + 0.5


TONEMAP_FUNCS: Dict[str, Callable] = {
    "gamma": simple_tone_map, "off": no_tone_map,
    "normalize": normalize_tone_map}


def exclusive_transmission(opacity: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative transmission prod_{j<i} (1 - op_j + 1e-10)."""
    acc = torch.cumprod(1.0 - opacity + 1e-10, dim=-1)
    return torch.cat([torch.ones_like(acc[..., :1]), acc[..., :-1]], -1)


def ray_march(ray_dist, ray_valid, ray_features, render_func, blend_func,
              bg_color: Optional[torch.Tensor] = None):
    """Alpha-composite decoded features along each ray.
    ray_dist [R, SR]; ray_valid [R, SR] bool; ray_features [R, SR, 1+C].
    Returns (ray_color, point_color, opacity, acc, blend_weight,
    background_transmission, background_blend_weight)."""
    point_color = render_func(ray_features)
    sigma = ray_features[..., 0] * ray_valid.to(ray_features.dtype)
    opacity = 1.0 - torch.exp(-sigma * ray_dist)
    acc_full = torch.cumprod(1.0 - opacity + 1e-10, dim=-1)
    background_transmission = acc_full[..., -1:]
    acc = torch.cat([torch.ones_like(acc_full[..., :1]), acc_full[..., :-1]],
                    -1)
    blend_weight = blend_func(opacity, acc)[..., None]
    ray_color = torch.sum(point_color * blend_weight, dim=-2)
    if bg_color is not None:
        ray_color = ray_color + bg_color.reshape(1, -1) * \
            background_transmission
    background_blend_weight = blend_func(1.0, background_transmission)
    return (ray_color, point_color, opacity, acc, blend_weight,
            background_transmission, background_blend_weight)
