"""DTU MVS dataset for generalization (feed-forward) training.

Counterpart of `pointnerf_tpu/data/dtu.py` (`read_cam_file`,
`read_pair_file`, `DtuDataset`, registered as "dtu"); PNGs are read with the
port's own reader.

Standard MVSNet-processed DTU layout:
  Cameras/pair.txt                 — per-view ranked source views
  Cameras/train/<i>_cam.txt        — extrinsic (4x4), intrinsic (3x3),
                                     "depth_min depth_interval" line
  Rectified/scan<id>_train/rect_<i+1>_<light>_r5000.png

Items are MVS view groups (ref + nsrc neighbors) for
train/feedforward.MVSBatch; the target rays come from the reference view.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..camera import get_dtu_raydir
from ..config import DataConfig
from ..utils.visualizer import read_png
from . import register_dataset


def read_cam_file(path: str) -> Tuple[np.ndarray, np.ndarray, float, float]:
    with open(path) as f:
        lines = [l.strip() for l in f.readlines()]
    ext = np.array(" ".join(lines[1:5]).split(),
                   dtype=np.float32).reshape(4, 4)
    intr = np.array(" ".join(lines[7:10]).split(),
                    dtype=np.float32).reshape(3, 3)
    vals = [float(v) for v in lines[11].split()]
    depth_min = vals[0]
    depth_interval = vals[1] if len(vals) > 1 else 2.5
    return ext, intr, depth_min, depth_interval


def read_pair_file(path: str) -> List[Tuple[int, List[int]]]:
    with open(path) as f:
        n = int(f.readline())
        out = []
        for _ in range(n):
            ref = int(f.readline())
            toks = f.readline().split()
            srcs = [int(toks[1 + 2 * i]) for i in range(int(toks[0]))]
            out.append((ref, srcs))
    return out


@register_dataset("dtu")
class DtuDataset:
    def __init__(self, cfg: DataConfig, split: Optional[str] = None,
                 nsrc: int = 2, light: int = 3, n_depths: int = 128):
        self.cfg = cfg
        self.split = split or cfg.split
        self.root = cfg.data_root
        self.nsrc = nsrc
        self.light = light
        self.n_depths = n_depths
        self.scan = cfg.scan
        self.pairs = read_pair_file(
            os.path.join(self.root, "Cameras", "pair.txt"))
        self.total = len(self.pairs)
        self.id_list = list(range(self.total))
        probe = self._img(self.pairs[0][0])
        self.height, self.width = probe.shape[:2]
        _, self.intrinsic, dm, di = self._cam(self.pairs[0][0])
        self.near = float(dm)
        self.far = float(dm + di * n_depths)

    def __len__(self):
        return self.total

    def _cam(self, vid: int):
        return read_cam_file(os.path.join(
            self.root, "Cameras", "train", f"{vid:08d}_cam.txt"))

    def _img(self, vid: int) -> np.ndarray:
        p = os.path.join(self.root, "Rectified", f"{self.scan}_train",
                         f"rect_{vid + 1:03d}_{self.light}_r5000.png")
        return read_png(p).astype(np.float32) / 255.0

    def get_mvs_item(self, idx: int) -> Dict[str, np.ndarray]:
        """One MVS group: images [V,H,W,3] (V=1+nsrc, view 0 = ref),
        Ks, w2cs, depth_values."""
        ref, srcs = self.pairs[idx]
        vids = [ref] + srcs[: self.nsrc]
        imgs, Ks, w2cs = [], [], []
        d_min = d_int = None
        for v in vids:
            ext, intr, dm, di = self._cam(v)
            imgs.append(self._img(v)[..., :3])
            Ks.append(intr)
            w2cs.append(ext)
            if v == ref:
                d_min, d_int = dm, di
        depth_values = d_min + d_int * np.arange(self.n_depths,
                                                 dtype=np.float32)
        return {"images": np.stack(imgs), "Ks": np.stack(Ks),
                "w2cs": np.stack(w2cs), "depth_values": depth_values,
                "ref_id": ref}

    def get_item(self, idx: int, random_sample: str = "random",
                 random_sample_size: int = 32,
                 seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Target rays from the reference view of group idx."""
        ref, _ = self.pairs[idx]
        ext, intr, dm, di = self._cam(ref)
        img = self._img(ref)[..., :3]
        H, W = img.shape[:2]
        c2w = np.linalg.inv(ext)
        rng = np.random.RandomState(seed if seed is not None else idx)
        if random_sample == "random":
            px = rng.randint(0, W, (random_sample_size ** 2,))
            py = rng.randint(0, H, (random_sample_size ** 2,))
        else:
            gx, gy = np.meshgrid(np.arange(W), np.arange(H))
            px, py = gx.ravel(), gy.ravel()
        pix = np.stack([px, py], -1).astype(np.float32)
        raydir = get_dtu_raydir(pix, intr, c2w[:3, :3].astype(np.float32),
                                bool(self.cfg.dir_norm)).astype(np.float32)
        return {"campos": c2w[:3, 3].astype(np.float32),
                "camrotc2w": c2w[:3, :3].astype(np.float32),
                "raydir": raydir, "pixel_idx": pix.astype(np.int32),
                "gt_image": img[py, px],
                "near": dm, "far": dm + di * self.n_depths,
                "intrinsic": intr, "id": idx,
                "bg_color": np.zeros(3, np.float32), "h": H, "w": W}
