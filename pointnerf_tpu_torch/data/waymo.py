"""Waymo sequence dataset (pre-exported npz bundles).

Counterpart of `pointnerf_tpu/data/waymo.py` (`WaymoDataset`, registered as
"waymo_ft"): one sequence's bundle as `data/waymo_export.frames_to_npz`
writes it (images, c2w poses, intrinsic, and the LiDAR cloud as
points_xyz_all or points_xyz); every 10th frame is the test split. Items
are dicts of numpy arrays with the JAX package's keys and values.

A scene of several sequences (`load_multiseq`) is one dataset per
sequence; `parallel/sharded.partition_points_multiseq` maps their clouds
onto the mp point axis of a sharded run.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..camera import get_dtu_raydir
from ..config import DataConfig
from . import register_dataset


@register_dataset("waymo_ft")
class WaymoDataset:
    def __init__(self, cfg: DataConfig, split: Optional[str] = None,
                 bg_color=(0.0, 0.0, 0.0), npz_path: Optional[str] = None):
        self.cfg = cfg
        self.split = split or cfg.split
        self.bg_color = np.asarray(bg_color, np.float32)
        path = npz_path or os.path.join(cfg.data_root, cfg.scan + ".npz")
        data = np.load(path)
        images = np.asarray(data["images"], np.float32)
        if images.max() > 1.5:
            images = images / 255.0
        if images.shape[1] in (3, 4):              # NCHW export -> NHWC
            images = np.transpose(images, (0, 2, 3, 1))
        self.images = images[..., :3]
        self.poses = np.asarray(data["poses"], np.float32)    # [F,4,4] c2w
        self.intrinsic = np.asarray(data["intrinsic"], np.float32)[:3, :3]
        self.height, self.width = self.images.shape[1:3]
        key = "points_xyz_all" if "points_xyz_all" in data else "points_xyz"
        self.points_xyz = (np.asarray(data[key], np.float32)
                           if key in data else None)
        ids = list(range(len(self.images)))
        self.id_list = (ids[::10] if self.split != "train"
                        else [i for i in ids if i % 10 != 0])
        self.total = len(self.id_list)
        self.near, self.far = 0.5, 80.0

    def __len__(self):
        return self.total

    def get_item(self, idx: int, random_sample: str = "random",
                 random_sample_size: int = 56,
                 seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        """The rays of the split's idx-th frame, sampled as
        `data/nsvf.NsvfDataset.get_item` samples them."""
        i = self.id_list[idx]
        pose = self.poses[i]
        H, W = self.height, self.width
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
                "gt_image": self.images[i][py, px], "near": self.near,
                "far": self.far, "intrinsic": self.intrinsic,
                "id": i, "frame_id": i,
                "bg_color": self.bg_color, "h": H, "w": W}

    def load_init_points(self) -> Dict[str, np.ndarray]:
        if self.points_xyz is None:
            raise FileNotFoundError("npz bundle has no LiDAR points")
        return {"xyz": self.points_xyz.reshape(-1, 3)}


def load_multiseq(cfg: DataConfig, scans: Sequence[str], split: str = "train"
                  ) -> List[WaymoDataset]:
    """A multi-sequence scene: one dataset (and point cloud) per sequence
    (`<data_root>/<scan>.npz` each), in the order of `scans`."""
    return [WaymoDataset(DataConfig(
        dataset_name=cfg.dataset_name, data_root=cfg.data_root, scan=s,
        img_wh=cfg.img_wh, dir_norm=cfg.dir_norm, split=split))
        for s in scans]
