"""LLFF (forward-facing) per-scene dataset.

Counterpart of `pointnerf_tpu/data/llff.py` (`llff_to_opencv`,
`LlffDataset`, registered as "llff_ft"): `poses_bounds.npy` holds [N, 17]
rows — a 3x5 matrix (c2w | [H, W, focal]) in LLFF's (down, right, back)
convention plus near/far bounds — turned into OpenCV's (right, down,
forward) convention. Frames come from `images/` or `images_{factor}/`,
every 8th is a test frame, the focal length is rescaled by the frames'
width, and near/far are the bounds' extremes times 0.9 and 1.1.

Frames are read by extension (`utils/visualizer.read_image`): JPEG through
Pillow as imageio.v2.imread reads it, PNG with the port's PNG reader.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np

from ..camera import get_dtu_raydir
from ..config import DataConfig
from ..utils.visualizer import read_image
from . import register_dataset


def llff_to_opencv(pose_3x5: np.ndarray):
    """c2w [4, 4] in OpenCV's convention from LLFF's 3x5 pose: the columns
    [down, right, back] become [right, down, forward]."""
    c2w = np.eye(4, dtype=np.float32)
    R = pose_3x5[:, :3]
    t = pose_3x5[:, 3]
    c2w[:3, 0] = R[:, 1]
    c2w[:3, 1] = R[:, 0]
    c2w[:3, 2] = -R[:, 2]
    c2w[:3, 3] = t
    return c2w


@register_dataset("llff_ft")
class LlffDataset:
    def __init__(self, cfg: DataConfig, split: Optional[str] = None,
                 bg_color=(0.0, 0.0, 0.0), factor: int = 1,
                 test_every: int = 8):
        self.cfg = cfg
        self.split = split or cfg.split
        self.root = os.path.join(cfg.data_root, cfg.scan)
        self.bg_color = np.asarray(bg_color, np.float32)
        pb = np.load(os.path.join(self.root, "poses_bounds.npy"))
        poses = pb[:, :15].reshape(-1, 3, 5)
        self.bounds = pb[:, 15:17]
        img_dir = os.path.join(
            self.root, "images" if factor == 1 else f"images_{factor}")
        paths = sorted(glob.glob(os.path.join(img_dir, "*.jpg"))
                       + glob.glob(os.path.join(img_dir, "*.png")))
        assert len(paths) == len(poses), (len(paths), len(poses))
        n = len(paths)
        test_ids = set(range(0, n, test_every))
        keep = [i for i in range(n)
                if (i in test_ids) == (self.split != "train")]
        self.images = np.stack([
            read_image(paths[i]).astype(np.float32) / 255.0
            for i in keep])[..., :3]
        self.poses = np.stack([llff_to_opencv(poses[i]) for i in keep])
        H, W, f = poses[0][:, 4]
        self.height, self.width = self.images.shape[1:3]
        scale = self.width / W
        self.intrinsic = np.array(
            [[f * scale, 0, self.width / 2.0],
             [0, f * scale, self.height / 2.0], [0, 0, 1]], np.float32)
        self.near = float(self.bounds.min()) * 0.9
        self.far = float(self.bounds.max()) * 1.1
        self.total = len(keep)
        self.id_list = list(range(self.total))

    def __len__(self):
        return self.total

    def get_item(self, idx: int, random_sample: str = "no_crop",
                 random_sample_size: int = 60,
                 seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        H, W = self.height, self.width
        pose = self.poses[idx]
        rng = np.random.RandomState(seed if seed is not None else idx)
        if random_sample == "random":
            px = rng.randint(0, W, (random_sample_size ** 2,))
            py = rng.randint(0, H, (random_sample_size ** 2,))
        else:
            gx, gy = np.meshgrid(np.arange(W), np.arange(H))
            px, py = gx.ravel(), gy.ravel()
        pix = np.stack([px, py], -1).astype(np.float32)
        raydir = get_dtu_raydir(pix, self.intrinsic, pose[:3, :3],
                                bool(self.cfg.dir_norm)).astype(np.float32)
        return {"campos": pose[:3, 3], "camrotc2w": pose[:3, :3],
                "raydir": raydir, "pixel_idx": pix.astype(np.int32),
                "gt_image": self.images[idx][py, px], "near": self.near,
                "far": self.far, "intrinsic": self.intrinsic, "id": idx,
                "bg_color": self.bg_color, "h": H, "w": W}
