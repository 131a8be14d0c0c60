"""NSVF-format per-scene dataset (Tanks&Temples splits).

Counterpart of `pointnerf_tpu/data/nsvf.py` (`NsvfDataset`, registered as
"tt_ft" and "nsvf"): a scene directory with `intrinsics.txt` (a 4x4 matrix
or an "f cx cy" line), `pose/<stem>.txt` (4x4 camera-to-world),
`rgb/<stem>.png` whose prefix names the split (0_ train, 1_ val, 2_ test;
a scene without prefixes puts every image in every split) and an optional
`bbox.txt` (the scene's AABB, which sets near and far). RGBA images are
composited on the background as the JAX package does. Items are dicts of
numpy arrays with the JAX package's keys and values.

Images are read with the port's own PNG reader (8-bit RGB or RGBA).
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np

from ..camera import get_dtu_raydir
from ..config import DataConfig
from ..utils.visualizer import read_png
from . import register_dataset
from .ply import load_ply


def _read_intrinsics(path: str) -> np.ndarray:
    vals = np.loadtxt(path)
    if vals.ndim == 2 and vals.shape == (4, 4):
        return vals[:3, :3].astype(np.float32)
    f, cx, cy = float(vals.flat[0]), float(vals.flat[1]), float(vals.flat[2])
    return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float32)


def _read_rgb(path: str, bg_color: np.ndarray) -> np.ndarray:
    """[H, W, 3] float32 in [0, 1]; RGBA composited on bg_color."""
    raw = read_png(path)
    if raw.ndim != 3 or raw.shape[-1] not in (3, 4):
        raise ValueError(f"{path}: an NSVF image must be RGB or RGBA")
    im = raw.astype(np.float32) / 255.0
    if im.shape[-1] == 4:
        im = im[..., :3] * im[..., 3:] + bg_color * (1 - im[..., 3:])
    return im[..., :3]


@register_dataset("tt_ft")
@register_dataset("nsvf")
class NsvfDataset:
    def __init__(self, cfg: DataConfig, split: Optional[str] = None,
                 bg_color=(1.0, 1.0, 1.0)):
        self.cfg = cfg
        self.split = split or cfg.split
        self.root = os.path.join(cfg.data_root, cfg.scan)
        self.bg_color = np.asarray(bg_color, np.float32)
        prefix = {"train": "0_", "val": "1_", "test": "2_"}[self.split]
        rgb_paths = sorted(glob.glob(os.path.join(self.root, "rgb",
                                                  prefix + "*")))
        if not rgb_paths:
            rgb_paths = sorted(glob.glob(os.path.join(self.root, "rgb", "*")))
        imgs, poses = [], []
        for p in rgb_paths:
            imgs.append(_read_rgb(p, self.bg_color))
            stem = os.path.splitext(os.path.basename(p))[0]
            poses.append(np.loadtxt(os.path.join(
                self.root, "pose", stem + ".txt")).astype(np.float32))
        self.images = np.stack(imgs)
        self.poses = np.stack(poses)              # c2w, OpenCV convention
        self.height, self.width = self.images.shape[1:3]
        self.intrinsic = _read_intrinsics(
            os.path.join(self.root, "intrinsics.txt"))
        self.total = len(imgs)
        self.id_list = list(range(self.total))
        bbox_path = os.path.join(self.root, "bbox.txt")
        self.bbox = (np.loadtxt(bbox_path).astype(np.float32)[:6]
                     if os.path.exists(bbox_path) else None)
        self.near, self.far = self._near_far()

    def _near_far(self):
        """From the camera centers' distances to the AABB's two corners:
        half the least, 1.5 x the most (0.5 and 10 without a bbox)."""
        if self.bbox is None:
            return 0.5, 10.0
        centers = self.poses[:, :3, 3]
        corners = self.bbox.reshape(2, 3)
        d = np.linalg.norm(centers[:, None] - corners[None], axis=-1)
        return max(float(d.min()) * 0.5, 0.01), float(d.max()) * 1.5

    def __len__(self):
        return self.total

    def get_item(self, idx: int, random_sample: str = "no_crop",
                 random_sample_size: int = 60,
                 seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        """One view's rays: `random_sample_size`^2 random pixels ("random"),
        a square patch ("patch") or every pixel ("no_crop"), drawn from
        np.random.RandomState(seed, else idx)."""
        H, W = self.height, self.width
        pose = self.poses[idx]
        rng = np.random.RandomState(seed if seed is not None else idx)
        if random_sample == "random":
            px = rng.randint(0, W, (random_sample_size ** 2,))
            py = rng.randint(0, H, (random_sample_size ** 2,))
        elif random_sample == "patch":
            s = random_sample_size
            x0, y0 = rng.randint(0, W - s + 1), rng.randint(0, H - s + 1)
            gx, gy = np.meshgrid(np.arange(x0, x0 + s), np.arange(y0, y0 + s))
            px, py = gx.ravel(), gy.ravel()
        else:
            gx, gy = np.meshgrid(np.arange(W), np.arange(H))
            px, py = gx.ravel(), gy.ravel()
        pix = np.stack([px, py], -1).astype(np.float32)
        raydir = get_dtu_raydir(pix, self.intrinsic, pose[:3, :3],
                                bool(self.cfg.dir_norm)).astype(np.float32)
        return {"campos": pose[:3, 3], "camrotc2w": pose[:3, :3],
                "raydir": raydir, "pixel_idx": pix.astype(np.int32),
                "gt_image": self.images[idx][py, px],
                "near": self.near, "far": self.far,
                "intrinsic": self.intrinsic, "id": idx,
                "bg_color": self.bg_color, "h": H, "w": W}

    def load_init_points(self) -> Dict[str, np.ndarray]:
        for rel in ("points.ply", "init.ply",
                    os.path.join("colmap_results", "dense", "fused.ply")):
            p = os.path.join(self.root, rel)
            if os.path.exists(p):
                return load_ply(p)
        raise FileNotFoundError(f"no init cloud under {self.root}")
