"""Visual-hull filtering and background-plane point generation.

Counterpart of `pointnerf_tpu/mvs/masking.py`: `alpha_masking` (keep the
points whose projection lands on a non-transparent pixel in every init
view, optionally within the camera-space near/far range; numpy),
`ray_plane_cross` and `gen_bg_points` (ray/plane intersections that seed
background-plane points; tensors).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def alpha_masking(points: np.ndarray, alphas: Sequence[np.ndarray],
                  intrinsics: Sequence[np.ndarray],
                  w2cs: Sequence[np.ndarray],
                  near_far: Optional[Tuple[float, float]] = None,
                  alpha_thresh: float = 0.1,
                  keep_outside_view: bool = True) -> np.ndarray:
    """A bool mask over the points that survive the visual hull. points
    [N, 3]; alphas per view [H, W] in [0, 1]. With keep_outside_view a
    point projecting outside an image counts as visible in that view."""
    n = points.shape[0]
    keep = np.ones(n, bool)
    for alpha, K, w2c in zip(alphas, intrinsics, w2cs):
        H, W = alpha.shape
        xyz1 = np.concatenate([points, np.ones((n, 1), points.dtype)], -1)
        cam = (xyz1 @ np.asarray(w2c, points.dtype).T)[:, :3]
        view_ok = np.ones(n, bool)
        if near_far is not None:
            view_ok &= ((cam[:, 2] >= near_far[0] - 1.0)
                        & (cam[:, 2] <= near_far[1]))
        pix = cam @ np.asarray(K, points.dtype).T
        with np.errstate(divide="ignore", invalid="ignore"):
            xy = np.floor(pix[:, :2] / pix[:, 2:3]).astype(np.int64)
        in_img = ((xy[:, 0] >= 0) & (xy[:, 0] < W)
                  & (xy[:, 1] >= 0) & (xy[:, 1] < H) & (cam[:, 2] > 0))
        xc = np.clip(xy[:, 0], 0, W - 1)
        yc = np.clip(xy[:, 1], 0, H - 1)
        visible = np.asarray(alpha)[yc, xc] > alpha_thresh
        if keep_outside_view:
            visible |= ~in_img
        keep &= visible & view_ok
    return keep


def ray_plane_cross(campos: torch.Tensor, raydir: torch.Tensor,
                    plane_pnt: torch.Tensor, plane_normal: torch.Tensor,
                    epsilon: float = 1e-3):
    """campos [3]; raydir [R, 3]. Returns (points [R, 3], valid [R]): rays
    with dot(normal, dir) < eps are invalid and give zeros."""
    dot = torch.sum(plane_normal[None] * raydir, -1)
    valid = dot >= epsilon
    w = campos[None] - plane_pnt[None]
    fac = -torch.sum(plane_normal[None] * w, -1) / torch.where(
        valid, dot, torch.ones_like(dot))
    pts = campos[None] + raydir * fac[:, None]
    return torch.where(valid[:, None], pts, torch.zeros_like(pts)), valid


def gen_bg_points(campos, raydir, plane_pnt, plane_normal):
    """Background-plane points for a ray batch (tensors or arrays):
    (points [R, 3], valid [R])."""
    raydir = torch.as_tensor(raydir, dtype=torch.float32)
    return ray_plane_cross(*[torch.as_tensor(a, dtype=torch.float32,
                                             device=raydir.device)
                             for a in (campos, raydir, plane_pnt,
                                       plane_normal)])
