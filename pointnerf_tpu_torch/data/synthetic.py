"""Procedural synthetic scene: a textured sphere shell with analytic ground
truth — the port's own copy of `pointnerf_tpu/data/synthetic.py` (numpy
only, same seeds, same arrays). Serves the roles the reference fills with downloaded NeRF-Synthetic
data (data/nerf_synth360_ft_dataset.py) in environments without datasets:
unit tests, benchmarks, and end-to-end training demos all share it. The
analytic renderer gives exact GT pixels, so time-to-PSNR measurements are
meaningful.

Conventions match the framework: OpenCV-style cameras (+z forward),
`camrotc2w` camera-to-world rotation, intrinsics K = [[f,0,cx],[0,f,cy],[0,0,1]].
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..camera import get_dtu_raydir


def sphere_scene(n_pts: int = 20000, radius: float = 0.5, seed: int = 0,
                 noise: float = 0.0):
    """Points uniform on a sphere shell with a procedural albedo texture.

    Returns (xyz [N,3], color [N,3] in [0,1], normals [N,3])."""
    rng = np.random.RandomState(seed)
    v = rng.normal(size=(n_pts, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True) + 1e-9
    xyz = v * radius
    if noise > 0:
        xyz = xyz + rng.normal(scale=noise, size=xyz.shape).astype(np.float32)
    color = _sphere_albedo(v)
    return xyz.astype(np.float32), color, v.astype(np.float32)


def _sphere_albedo(n: np.ndarray) -> np.ndarray:
    """Smooth multi-band texture on unit directions n [...,3]."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    r = 0.5 + 0.5 * np.sin(4.0 * x + 2.0 * y)
    g = 0.5 + 0.5 * np.sin(3.0 * y - 4.0 * z)
    b = 0.5 + 0.5 * np.cos(5.0 * z + 3.0 * x)
    return np.stack([r, g, b], axis=-1).astype(np.float32) * 0.8 + 0.1


def look_at(campos: np.ndarray, target: np.ndarray,
            up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """OpenCV camera-to-world rotation with +z looking at `target`."""
    z = target - campos
    z = z / (np.linalg.norm(z) + 1e-9)
    x = np.cross(np.asarray(up, np.float32), z)
    x = x / (np.linalg.norm(x) + 1e-9)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=-1).astype(np.float32)  # columns = axes


def ring_cameras(n_views: int = 8, radius: float = 3.0, height: float = 0.8,
                 focal: float = 300.0, wh: Tuple[int, int] = (256, 256)):
    """Cameras on a ring looking at the origin. Returns list of
    (campos [3], camrotc2w [3,3], intrinsic [3,3])."""
    W, H = wh
    K = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1]],
                 np.float32)
    views = []
    for i in range(n_views):
        th = 2.0 * np.pi * i / n_views
        campos = np.array([radius * np.cos(th), height, radius * np.sin(th)],
                          np.float32)
        rot = look_at(campos, np.zeros(3, np.float32))
        views.append((campos, rot, K))
    return views


def sphere_gt_render(campos: np.ndarray, raydir: np.ndarray,
                     radius: float = 0.5,
                     bg=(1.0, 1.0, 1.0)) -> np.ndarray:
    """Analytic GT: first ray-sphere intersection shaded with the albedo
    texture + Lambert term; misses get the background. raydir [R,3] (need
    not be normalized). Returns [R,3] float32."""
    d = raydir / (np.linalg.norm(raydir, axis=-1, keepdims=True) + 1e-9)
    o = campos[None, :]
    b = np.sum(o * d, axis=-1)
    c = np.sum(o * o, axis=-1) - radius * radius
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit &= t > 0
    p = o + d * t[..., None]
    n = p / (np.linalg.norm(p, axis=-1, keepdims=True) + 1e-9)
    albedo = _sphere_albedo(n)
    light = np.asarray([0.577, 0.577, -0.577], np.float32)
    lam = np.clip(np.sum(n * light[None], axis=-1), 0.0, 1.0) * 0.5 + 0.5
    col = albedo * lam[..., None]
    out = np.broadcast_to(np.asarray(bg, np.float32), col.shape).copy()
    out[hit] = col[hit]
    return out.astype(np.float32)


def view_ray_batch(campos, camrot, K, wh: Tuple[int, int],
                   n_rays: Optional[int] = None, seed: int = 0,
                   radius: float = 0.5, view_id: Optional[int] = None):
    """Sample pixels of one view; returns dict of numpy arrays with analytic
    GT (keys mirror the reference item dict,
    data/nerf_synth360_ft_dataset.py:546-647)."""
    W, H = wh
    rng = np.random.RandomState(seed)
    if n_rays is None:
        u, v = np.meshgrid(np.arange(W), np.arange(H))
        pix = np.stack([u.ravel(), v.ravel()], axis=-1).astype(np.float32)
    else:
        pix = np.stack([rng.randint(0, W, n_rays),
                        rng.randint(0, H, n_rays)], axis=-1).astype(np.float32)
    raydir = get_dtu_raydir(pix, K, camrot, True).astype(np.float32)
    gt = sphere_gt_render(campos, raydir, radius=radius)
    return {"campos": campos, "camrotc2w": camrot, "raydir": raydir,
            "pixel_idx": pix.astype(np.int32), "gt_image": gt,
            "intrinsic": K, "id": view_id}
