"""Camera math: world <-> perspective transforms and ray directions.

Counterpart of `pointnerf_tpu/camera.py` (`w2pers`, `pers2w`,
`get_dtu_raydir`, `get_blender_raydir`, `BLENDER2OPENCV`,
`pose_spherical`). Poses follow the OpenCV convention (+z forward);
`camrotc2w` is the camera-to-world rotation.
"""
from __future__ import annotations

import numpy as np
import torch


def w2pers(xyz_w: torch.Tensor, camrotc2w: torch.Tensor,
           campos: torch.Tensor) -> torch.Tensor:
    """World -> perspective coords (x/z, y/z, z) in the camera frame.
    xyz_w [..., 3]; camrotc2w [3, 3]; campos [3]."""
    xyz_c = (xyz_w - campos) @ camrotc2w
    z = xyz_c[..., 2]
    return torch.stack([xyz_c[..., 0] / z, xyz_c[..., 1] / z, z], dim=-1)


def pers2w(xyz_pers: torch.Tensor, camrotc2w: torch.Tensor,
           campos: torch.Tensor) -> torch.Tensor:
    """Inverse of w2pers."""
    z = xyz_pers[..., 2]
    xyz_c = torch.stack([xyz_pers[..., 0] * z, xyz_pers[..., 1] * z, z],
                        dim=-1)
    return xyz_c @ camrotc2w.T + campos


def get_dtu_raydir(pixelcoords, intrinsic, camrotc2w, dir_norm: bool = False):
    """Pixel coords [..., 2] -> world ray dirs [..., 3]:
    x=(u+.5-cx)/fx, y=(v+.5-cy)/fy, z=1, rotated by the c2w rotation.
    Works on numpy arrays or torch tensors."""
    xp = torch if isinstance(pixelcoords, torch.Tensor) else np
    x = (pixelcoords[..., 0] + 0.5 - intrinsic[0, 2]) / intrinsic[0, 0]
    y = (pixelcoords[..., 1] + 0.5 - intrinsic[1, 2]) / intrinsic[1, 1]
    z = xp.ones_like(x)
    dirs = xp.stack([x, y, z], -1)
    dirs = dirs @ camrotc2w.T
    if dir_norm:
        norm = (torch.linalg.norm(dirs, dim=-1, keepdim=True) if xp is torch
                else np.linalg.norm(dirs, axis=-1, keepdims=True))
        dirs = dirs / (norm + 1e-5)
    return dirs


def get_blender_raydir(pixelcoords, height, width, focal, camrot,
                       dir_norm: bool = False):
    """Blender-convention ray dirs: x right, y up, looking down -z, rotated
    by camrot. Works on numpy arrays or torch tensors."""
    xp = torch if isinstance(pixelcoords, torch.Tensor) else np
    x = (pixelcoords[..., 0] + 0.5 - width / 2.0) / focal
    y = (pixelcoords[..., 1] + 0.5 - height / 2.0) / focal
    z = xp.ones_like(x)
    dirs = xp.stack([x, -y, -z], -1)
    dirs = (dirs[..., None, :] * camrot[:, :]).sum(-1)
    if dir_norm:
        norm = (torch.linalg.norm(dirs, dim=-1, keepdim=True) if xp is torch
                else np.linalg.norm(dirs, axis=-1, keepdims=True))
        dirs = dirs / (norm + 1e-5)
    return dirs


# blender (+y up, -z forward) -> OpenCV (+y down, +z forward) camera axes
BLENDER2OPENCV = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]],
    dtype=np.float32)


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Camera-to-world pose [4, 4] of the spiral render path (blender
    convention): `radius` out, pitched by `phi` and turned by `theta`
    degrees."""
    trans_t = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, radius],
                        [0, 0, 0, 1]], dtype=np.float32)
    ph = phi / 180.0 * np.pi
    th = theta / 180.0 * np.pi
    rot_phi = np.array([[1, 0, 0, 0], [0, np.cos(ph), -np.sin(ph), 0],
                        [0, np.sin(ph), np.cos(ph), 0], [0, 0, 0, 1]],
                       dtype=np.float32)
    rot_theta = np.array([[np.cos(th), 0, -np.sin(th), 0], [0, 1, 0, 0],
                          [np.sin(th), 0, np.cos(th), 0], [0, 0, 0, 1]],
                         dtype=np.float32)
    c2w = rot_theta @ rot_phi @ trans_t
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                     [0, 0, 0, 1]], dtype=np.float32)
    return flip @ c2w
