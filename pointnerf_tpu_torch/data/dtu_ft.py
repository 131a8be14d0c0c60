"""DTU per-scene finetune dataset.

Counterpart of `pointnerf_tpu/data/dtu_ft.py` (`DtuFtDataset`, registered
as "dtu_ft"; PNGs through the port's own reader).

The finetune-after-feedforward protocol (BASELINE.json config #5): a DTU
scan's MVSNet-layout directory is optimized per scene after MVS point
initialization. Layout (dtu_ft_dataset.py:530-590, 438-466):

  Cameras/train/{vid:08d}_cam.txt          extrinsic 4x4 / QUARTER-res
                                           intrinsic 3x3 / "depth_min
                                           depth_interval" line
  Cameras/pair.txt                         per-view ranked source views
  Rectified/{scan}_train/rect_{vid+1:03d}_{light}_r5000.png
  Depths_raw/{scan}/depth_map_{vid:04d}.pfm   (optional GT depth)
  dtu_configs/dtu_finetune_init_pairs.txt  (optional; reference ships this
                                           in ../data — falls back to
                                           Cameras/pair.txt groups)

Reference conventions reproduced exactly: translation and depth scaled by
scale_factor = 1/200 (:102), cam-file intrinsics x4 to full res (:449),
near/far from the depth line as [d_min, d_min + d_int * 192 * 1.06]
(:316-318), plane-sweep proj mats at 1/4 feature res (:458-461).

Train ids = the init-pair reference views (:399-416). Test ids default to
every 7th remaining view — the reference reads its split from an
unpublished pairs.th blob (:107), so the split is configurable via
`test_ids`.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..camera import get_dtu_raydir
from ..config import DataConfig
from ..utils.visualizer import read_png
from . import register_dataset
from .dtu import read_cam_file, read_pair_file

SCALE_FACTOR = 1.0 / 200.0


def _read_init_pairs(path: str) -> List[List[int]]:
    """dtu_finetune_init_pairs.txt: count, then (ref line, comma-separated
    src line) pairs (dtu_ft_dataset.py:401-410)."""
    groups = []
    with open(path) as f:
        n = int(f.readline())
        for _ in range(n):
            ref = int(f.readline().rstrip())
            srcs = [int(x) for x in f.readline().rstrip().split(",")]
            groups.append([ref] + srcs)
    return groups


@register_dataset("dtu_ft")
class DtuFtDataset:
    def __init__(self, cfg: DataConfig, split: Optional[str] = None,
                 n_views: int = 3, light: int = 3, n_depths: int = 192,
                 test_ids: Optional[Sequence[int]] = None):
        self.cfg = cfg
        self.split = split or cfg.split
        self.root = cfg.data_root
        self.scan = cfg.scan
        self.light = light
        self.n_views = n_views
        self.n_depths = n_depths

        pairs_file = os.path.join(self.root, "dtu_configs",
                                  "dtu_finetune_init_pairs.txt")
        if os.path.exists(pairs_file):
            self.view_id_list = _read_init_pairs(pairs_file)
        else:
            ranked = read_pair_file(
                os.path.join(self.root, "Cameras", "pair.txt"))
            self.view_id_list = [[r] + s[: max(2, n_views - 1)]
                                 for r, s in ranked]
        train_ids = [g[0] for g in self.view_id_list]
        if test_ids is None:
            all_ids = sorted({v for g in self.view_id_list for v in g})
            test_ids = [v for v in all_ids if v not in train_ids][::7]

        self.id_list = list(train_ids if self.split == "train"
                            else test_ids)
        if not self.id_list:           # tiny fixtures: fall back to train
            self.id_list = list(train_ids)
        self.total = len(self.id_list)

        # load all views referenced by any split or init group
        need = sorted({v for g in self.view_id_list for v in g}
                      | set(self.id_list))
        self._cams: Dict[int, Tuple] = {}
        self._imgs: Dict[int, np.ndarray] = {}
        near_far = None
        for vid in need:
            ext, intr, d_min, d_int = read_cam_file(os.path.join(
                self.root, "Cameras", "train", f"{vid:08d}_cam.txt"))
            ext = ext.copy()
            ext[:3, 3] *= SCALE_FACTOR
            intr = intr.copy()
            intr[:2] *= 4.0                      # cam files are 1/4 res
            img = self._read_img(vid)
            H, W = img.shape[:2]
            self._cams[vid] = (ext, intr, d_min * SCALE_FACTOR,
                               d_int * SCALE_FACTOR)
            self._imgs[vid] = img
            if near_far is None:
                near_far = (d_min * SCALE_FACTOR,
                            (d_min + d_int * 192 * 1.06) * SCALE_FACTOR)
        self.near, self.far = near_far
        probe = self._imgs[need[0]]
        self.height, self.width = probe.shape[:2]

    def _read_img(self, vid: int) -> np.ndarray:
        p = os.path.join(self.root, "Rectified", f"{self.scan}_train",
                         f"rect_{vid + 1:03d}_{self.light}_r5000.png")
        return read_png(p).astype(np.float32)[..., :3] / 255.0

    def __len__(self):
        return self.total

    # ---- per-scene items (dtu_ft_dataset.py:699-809) ----------------------
    def get_item(self, idx: int, random_sample: str = "no_crop",
                 random_sample_size: int = 60,
                 seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        vid = self.id_list[idx]
        ext, intr, _dm, _di = self._cams[vid]
        img = self._imgs[vid]
        H, W = img.shape[:2]
        c2w = np.linalg.inv(ext)
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
        pix = np.stack([px, py], -1).astype(np.float32)
        camrot = c2w[:3, :3].astype(np.float32)
        raydir = get_dtu_raydir(pix, intr, camrot,
                                bool(self.cfg.dir_norm)).astype(np.float32)
        return {"campos": c2w[:3, 3].astype(np.float32),
                "camrotc2w": camrot, "raydir": raydir,
                "pixel_idx": pix.astype(np.int32),
                "gt_image": img[py, px].astype(np.float32),
                "near": self.near, "far": self.far, "intrinsic": intr,
                "id": idx, "bg_color": np.zeros(3, np.float32),
                "h": H, "w": W}

    # ---- MVS init groups (dtu_ft_dataset.py:619-687) -----------------------
    def get_mvs_item(self, idx: int) -> Dict[str, np.ndarray]:
        """Init group idx: images [V,H,W,3] (view 0 = ref), full-res Ks,
        scaled w2cs, and the ref view's plane-sweep depth values."""
        vids = self.view_id_list[idx % len(self.view_id_list)][: self.n_views]
        imgs, Ks, w2cs = [], [], []
        d_min = d_int = None
        for v in vids:
            ext, intr, dm, di = self._cams[v]
            imgs.append(self._imgs[v])
            Ks.append(intr)
            w2cs.append(ext)
            if d_min is None:
                d_min, d_int = dm, di
        depth_values = d_min + d_int * np.arange(self.n_depths,
                                                 dtype=np.float32)
        return {"images": np.stack(imgs).astype(np.float32),
                "Ks": np.stack(Ks).astype(np.float32),
                "w2cs": np.stack(w2cs).astype(np.float32),
                "depth_values": depth_values, "ref_id": vids[0]}

    def get_dummyrot_item(self, idx: int, n_frames: int = 40) -> Dict:
        """Render poses: interpolate between the first two train cameras
        (the reference uses gen_render_path over 3 poses, :149-150)."""
        ids = self.id_list
        a = np.linalg.inv(self._cams[ids[0]][0])
        b = np.linalg.inv(self._cams[ids[min(1, len(ids) - 1)]][0])
        t = 0.5 * (1 - np.cos(2 * np.pi * idx / n_frames))
        c2w = a * (1 - t) + b * t                     # simple linear blend
        # re-orthonormalize the rotation
        u, _, vt = np.linalg.svd(c2w[:3, :3])
        c2w[:3, :3] = u @ vt
        intr = self._cams[ids[0]][1]
        H, W = self.height, self.width
        gx, gy = np.meshgrid(np.arange(W), np.arange(H))
        pix = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
        raydir = get_dtu_raydir(pix, intr, c2w[:3, :3].astype(np.float32),
                                bool(self.cfg.dir_norm)).astype(np.float32)
        return {"campos": c2w[:3, 3].astype(np.float32),
                "camrotc2w": c2w[:3, :3].astype(np.float32),
                "raydir": raydir, "pixel_idx": pix.astype(np.int32),
                "gt_image": None, "near": self.near, "far": self.far,
                "intrinsic": intr, "id": idx,
                "bg_color": np.zeros(3, np.float32), "h": H, "w": W}
