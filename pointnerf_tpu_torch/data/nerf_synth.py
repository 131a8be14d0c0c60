"""NeRF-Synthetic (blender) per-scene dataset.

Counterpart of `pointnerf_tpu/data/nerf_synth.py` (`NerfSynthDataset`,
registered as "nerf_synth360_ft" and "nerf_synth_ft"): transforms_{split}.json
poses (blender convention, turned into OpenCV's by BLENDER2OPENCV), RGBA
images composited on the background, and the per-item ray sampling
policies `random_sample` in {random, patch, no_crop}. Items are dicts of
numpy arrays with the JAX package's keys and values.

Images are read with the port's own PNG reader. An image larger than
`img_wh` by an integer factor on both axes is shrunk by the mean of each
factor x factor block (what OpenCV's INTER_AREA computes for such a factor);
any other size raises.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from ..camera import BLENDER2OPENCV, get_dtu_raydir, pose_spherical
from ..config import DataConfig
from ..utils.visualizer import read_png
from . import register_dataset
from .ply import load_ply


def block_mean_resize(im: np.ndarray, wh) -> np.ndarray:
    """[H, W, C] float32 -> [h, w, C] by the mean of each block, for
    H = fy * h and W = fx * w with integer factors."""
    W, H = wh
    h0, w0 = im.shape[:2]
    if h0 % H or w0 % W:
        raise ValueError(f"resize {w0}x{h0} -> {W}x{H}: only integer "
                         "down-scale factors are supported")
    fy, fx = h0 // H, w0 // W
    blocks = im.reshape(H, fy, W, fx, -1).astype(np.float64)
    return blocks.mean(axis=(1, 3)).astype(np.float32)


@register_dataset("nerf_synth360_ft")
@register_dataset("nerf_synth_ft")
class NerfSynthDataset:
    def __init__(self, cfg: DataConfig, split: Optional[str] = None,
                 bg_color=(1.0, 1.0, 1.0)):
        self.cfg = cfg
        self.split = split or cfg.split
        self.root = os.path.join(cfg.data_root, cfg.scan)
        self.bg_color = np.asarray(bg_color, np.float32)
        self._load(self.split)

    def _load(self, split: str):
        with open(os.path.join(self.root, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        W, H = self.cfg.img_wh
        frames = meta["frames"]
        self.camera_angle_x = float(meta["camera_angle_x"])
        self.focal = 0.5 * W / np.tan(0.5 * self.camera_angle_x)
        self.intrinsic = np.array([[self.focal, 0, W / 2.0],
                                   [0, self.focal, H / 2.0],
                                   [0, 0, 1]], np.float32)
        self.height, self.width = H, W
        imgs, poses = [], []
        for fr in frames:
            im = read_png(os.path.join(self.root, fr["file_path"] + ".png"))
            im = im.astype(np.float32) / 255.0
            if im.ndim == 2:
                im = im[..., None]
            if im.shape[0] != H or im.shape[1] != W:
                im = block_mean_resize(im, (W, H))
            if im.shape[-1] == 4:   # composite on the background
                im = (im[..., :3] * im[..., 3:]
                      + self.bg_color * (1 - im[..., 3:]))
            imgs.append(im[..., :3])
            poses.append(np.asarray(fr["transform_matrix"], np.float32)
                         @ BLENDER2OPENCV)
        self.images = np.stack(imgs)          # [V, H, W, 3]
        self.poses = np.stack(poses)          # [V, 4, 4]
        self.total = len(frames)
        self.id_list = list(range(self.total))
        # the reference's lego near/far planes
        self.near = 2.0
        self.far = 6.0

    def __len__(self):
        return self.total

    def get_item(self, idx: int, random_sample: str = "no_crop",
                 random_sample_size: int = 60, seed: Optional[int] = None
                 ) -> Dict[str, np.ndarray]:
        """One view as an item dict: `random_sample_size`^2 random pixels
        ("random"), a square patch ("patch") or the full image ("no_crop"),
        drawn from RandomState(seed, else idx)."""
        H, W = self.height, self.width
        pose = self.poses[idx]
        campos = pose[:3, 3]
        camrot = pose[:3, :3]
        rng = np.random.RandomState(seed if seed is not None else idx)
        if random_sample == "random":
            px = rng.randint(0, W, (random_sample_size ** 2,))
            py = rng.randint(0, H, (random_sample_size ** 2,))
        elif random_sample == "patch":
            s = random_sample_size
            x0 = rng.randint(0, W - s + 1)
            y0 = rng.randint(0, H - s + 1)
            gx, gy = np.meshgrid(np.arange(x0, x0 + s),
                                 np.arange(y0, y0 + s))
            px, py = gx.ravel(), gy.ravel()
        else:
            gx, gy = np.meshgrid(np.arange(W), np.arange(H))
            px, py = gx.ravel(), gy.ravel()
        pix = np.stack([px, py], axis=-1).astype(np.float32)
        raydir = get_dtu_raydir(pix, self.intrinsic, camrot,
                                bool(self.cfg.dir_norm)).astype(np.float32)
        gt = self.images[idx][py, px]
        return {"campos": campos, "camrotc2w": camrot, "raydir": raydir,
                "pixel_idx": pix.astype(np.int32), "gt_image": gt,
                "near": self.near, "far": self.far,
                "intrinsic": self.intrinsic, "id": idx,
                "bg_color": self.bg_color, "h": H, "w": W}

    def get_dummyrot_item(self, idx: int, n_frames: int = 40,
                          phi: float = -30.0, radius: float = 4.0) -> Dict:
        """Frame `idx` of the spiral render path (no ground truth)."""
        theta = -180.0 + 360.0 * idx / n_frames
        c2w = pose_spherical(theta, phi, radius) @ BLENDER2OPENCV
        H, W = self.height, self.width
        gx, gy = np.meshgrid(np.arange(W), np.arange(H))
        pix = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
        raydir = get_dtu_raydir(pix, self.intrinsic, c2w[:3, :3],
                                bool(self.cfg.dir_norm)).astype(np.float32)
        return {"campos": c2w[:3, 3].astype(np.float32),
                "camrotc2w": c2w[:3, :3].astype(np.float32),
                "raydir": raydir, "pixel_idx": pix.astype(np.int32),
                "gt_image": None, "near": self.near, "far": self.far,
                "intrinsic": self.intrinsic, "id": idx,
                "bg_color": self.bg_color, "h": H, "w": W}

    def load_init_points(self) -> Dict[str, np.ndarray]:
        """The scene's init cloud: COLMAP's fused cloud
        (`colmap_results/dense/fused.ply`), else `points.ply` or
        `fused.ply` under the scene directory."""
        for rel in (os.path.join("colmap_results", "dense", "fused.ply"),
                    "points.ply", "fused.ply"):
            p = os.path.join(self.root, rel)
            if os.path.exists(p):
                return load_ply(p)
        raise FileNotFoundError(
            f"no init point cloud under {self.root} "
            "(looked for colmap_results/dense/fused.ply, points.ply)")
