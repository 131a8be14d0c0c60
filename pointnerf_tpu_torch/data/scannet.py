"""ScanNet per-scene dataset (exported frames).

Counterpart of `pointnerf_tpu/data/scannet.py` (`ScannetDataset`,
registered as "scannet_ft"): a scene directory with `color/<i>.png`,
`pose/<i>.txt` (4x4 c2w), `intrinsic/intrinsic_color.txt` and
`depth/<i>.png` (16-bit depth in millimetres), every 5th frame a test
frame. `load_init_points` unprojects every `step`-th frame's sensor depth,
resized to the color frame's size by nearest-neighbor sampling
(`resize_nearest`, OpenCV's INTER_NEAREST index rule in numpy).

Frames are read with the port's PNG reader; a JPEG color frame raises.
The train split keeps each color frame it has decoded (uint8, 3.8 MB at
1296 x 968), since its items are drawn again and again and the numpy PNG
decoder takes a few tenths of a second on a frame whose rows carry the
Average or Paeth filter; the test split reads each frame once a pass and
keeps none.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np

from .. import not_ported
from ..camera import get_dtu_raydir
from ..config import DataConfig
from ..utils.visualizer import read_png
from . import register_dataset


def resize_nearest(img: np.ndarray, wh) -> np.ndarray:
    """[H, W, ...] -> [h, w, ...] as cv2.resize(img, (w, h),
    interpolation=cv2.INTER_NEAREST): destination pixel x reads source
    pixel min(floor(x * (1 / (w / W))), W - 1), in double precision, and the
    same along y."""
    W, H = wh
    h0, w0 = img.shape[:2]

    def src(n_dst, n_src):
        inv = 1.0 / (n_dst / n_src)
        return np.minimum(np.floor(np.arange(n_dst) * inv).astype(np.int64),
                          n_src - 1)
    return img[src(H, h0)][:, src(W, w0)]


@register_dataset("scannet_ft")
class ScannetDataset:
    def __init__(self, cfg: DataConfig, split: Optional[str] = None,
                 bg_color=(0.0, 0.0, 0.0), step: int = 1):
        self.cfg = cfg
        self.split = split or cfg.split
        self.root = os.path.join(cfg.data_root, cfg.scan)
        self.bg_color = np.asarray(bg_color, np.float32)
        self._frames: Dict[int, np.ndarray] = {}
        ids = sorted(int(os.path.splitext(os.path.basename(p))[0])
                     for p in glob.glob(os.path.join(self.root, "color", "*")))
        # every 5th frame a test frame, the rest train (ScanNet convention)
        test_ids = ids[::5]
        train_ids = [i for i in ids if i not in set(test_ids)]
        self.id_list = (train_ids if self.split == "train"
                        else test_ids)[::step]
        self.intrinsic = np.loadtxt(os.path.join(
            self.root, "intrinsic", "intrinsic_color.txt")
        ).astype(np.float32)[:3, :3]
        probe = self._color(self.id_list[0])
        self.height, self.width = probe.shape[:2]
        self.total = len(self.id_list)
        self.near, self.far = 0.1, 10.0

    def _color_path(self, i):
        for ext in (".jpg", ".png"):
            p = os.path.join(self.root, "color", f"{i}{ext}")
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"frame {i}")

    def _color(self, i) -> np.ndarray:
        if i in self._frames:
            return self._frames[i]
        path = self._color_path(i)
        if path.endswith(".jpg"):
            raise not_ported(f"JPEG frames ({path})", "Queue 1, datasets")
        img = read_png(path)
        if self.split == "train":
            self._frames[i] = img
        return img

    def __len__(self):
        return self.total

    def _pose(self, i):
        return np.loadtxt(os.path.join(self.root, "pose", f"{i}.txt")
                          ).astype(np.float32)

    def get_item(self, idx: int, random_sample: str = "no_crop",
                 random_sample_size: int = 60,
                 seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        i = self.id_list[idx]
        img = self._color(i).astype(np.float32) / 255.0
        pose = self._pose(i)
        H, W = self.height, self.width
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
                "gt_image": img[..., :3][py, px], "near": self.near,
                "far": self.far, "intrinsic": self.intrinsic, "id": idx,
                "bg_color": self.bg_color, "h": H, "w": W}

    def load_init_points(self, step: int = 10, max_depth: float = 10.0,
                         depth_scale: float = 1000.0) -> Dict[str, np.ndarray]:
        """Sensor-depth point cloud: unproject every `step`-th frame's depth
        map (millimetres / depth_scale), resized to the color frame's size
        with nearest-neighbor sampling where the sizes differ."""
        xyz_all, col_all = [], []
        for idx in range(0, self.total, step):
            i = self.id_list[idx]
            dpath = os.path.join(self.root, "depth", f"{i}.png")
            if not os.path.exists(dpath):
                continue
            depth = read_png(dpath).astype(np.float32) / depth_scale
            img = self._color(i).astype(np.float32) / 255.0
            if depth.shape != img.shape[:2]:
                depth = resize_nearest(depth, (img.shape[1], img.shape[0]))
            pose = self._pose(i)
            H, W = depth.shape
            gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
            valid = (depth > 0) & (depth < max_depth)
            z = depth[valid]
            pix = np.stack([gx[valid], gy[valid], np.ones_like(z)], 0)
            cam = np.linalg.inv(self.intrinsic) @ (pix * z)
            world = (pose[:3, :3] @ cam + pose[:3, 3:4]).T
            xyz_all.append(world.astype(np.float32))
            col_all.append(img[..., :3][valid])
        xyz = (np.concatenate(xyz_all) if xyz_all
               else np.zeros((0, 3), np.float32))
        col = (np.concatenate(col_all) if col_all
               else np.zeros((0, 3), np.float32))
        return {"xyz": xyz, "color": col}
