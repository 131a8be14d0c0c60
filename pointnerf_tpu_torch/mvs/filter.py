"""Cross-view geometric consistency filtering of MVS depth maps.

Counterpart of `pointnerf_tpu/mvs/filter.py` (`reproject_with_depth`,
`check_geometric_consistency`, `filter_by_masks`): a reference-view depth
pixel survives if, reprojected into >= `geo_cnsst_num` source views and
back, it lands within 1 px of where it started with < 1% relative depth
difference, and its photometric confidence clears `depth_conf_thresh`. The
per-pair checks run on the device; the survivors are lifted to world points
on the host in float64, as in JAX.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..ops.sample2d import bilinear_sample


def _pixel_grid(H: int, W: int, dev):
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    return x, y


def reproject_with_depth(depth_ref, K_ref, E_ref, depth_src, K_src, E_src):
    """Project the reference depth into the source view, sample the source
    depth there and project back. depth_* [H, W]; K [3, 3]; E [4, 4]
    world -> camera. Returns (depth_reprojected, x_rep, y_rep, oor), each
    [H, W]."""
    H, W = depth_ref.shape
    x, y = _pixel_grid(H, W, depth_ref.device)
    pix = torch.stack([x, y, torch.ones_like(x)], 0).reshape(3, -1)
    cam_ref = torch.linalg.inv(K_ref) @ (pix * depth_ref.reshape(1, -1))
    rel = E_src @ torch.linalg.inv(E_ref)
    cam_src = rel[:3, :3] @ cam_ref + rel[:3, 3:4]
    z_src = cam_src[2]
    pix_src = K_src @ cam_src
    xs = pix_src[0] / torch.clamp(pix_src[2], min=1e-9)
    ys = pix_src[1] / torch.clamp(pix_src[2], min=1e-9)
    oor = (xs < 0) | (xs >= W) | (ys < 0) | (ys >= H) | (z_src <= 0)
    d_src = bilinear_sample(depth_src[None], xs, ys)[0]
    cam_src2 = torch.linalg.inv(K_src) @ (
        torch.stack([xs, ys, torch.ones_like(xs)], 0) * d_src.reshape(1, -1))
    rel_back = E_ref @ torch.linalg.inv(E_src)
    cam_ref2 = rel_back[:3, :3] @ cam_src2 + rel_back[:3, 3:4]
    depth_rep = cam_ref2[2].reshape(H, W)
    pix_ref2 = K_ref @ cam_ref2
    x_rep = (pix_ref2[0] / torch.clamp(pix_ref2[2], min=1e-9)).reshape(H, W)
    y_rep = (pix_ref2[1] / torch.clamp(pix_ref2[2], min=1e-9)).reshape(H, W)
    return depth_rep, x_rep, y_rep, oor.reshape(H, W)


def check_geometric_consistency(depth_ref, K_ref, E_ref, depth_src, K_src,
                                E_src):
    """Returns (geo_mask, vis_mask, depth_reprojected), each [H, W]: geo
    where the round trip lands within 1 px with < 1% relative depth
    difference, the reprojected depth zero elsewhere."""
    H, W = depth_ref.shape
    x, y = _pixel_grid(H, W, depth_ref.device)
    depth_rep, x_rep, y_rep, oor = reproject_with_depth(
        depth_ref, K_ref, E_ref, depth_src, K_src, E_src)
    dist = torch.sqrt((x_rep - x) ** 2 + (y_rep - y) ** 2)
    rel_diff = (depth_rep - depth_ref).abs() / torch.clamp(depth_ref,
                                                          min=1e-9)
    geo = (dist < 1.0) & (rel_diff < 0.01)
    depth_rep = torch.where(geo, depth_rep, torch.zeros((), device=geo.device))
    return geo, ~oor, depth_rep


def filter_by_masks(depths: Sequence, confs: Sequence,
                    intrinsics: Sequence[np.ndarray],
                    extrinsics: Sequence[np.ndarray],
                    depth_conf_thresh: float = 0.8, geo_cnsst_num: int = 3,
                    masks: Optional[Sequence] = None,
                    device: DeviceLike = None
                    ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Per reference view: the averaged consistent depth of its surviving
    pixels lifted to world points. depths / confs: per view [H, W] (numpy
    or tensors); intrinsics [3, 3] and extrinsics [4, 4] per view. Returns
    (xyz_world per view [M, 3], confidence per view [M]), numpy float32."""
    dev = resolve_device(device)

    def t(a):
        if torch.is_tensor(a):
            return a.to(dev, torch.float32)
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    V = len(depths)
    Ks = [t(k) for k in intrinsics]
    Es = [t(e) for e in extrinsics]
    ds = [t(d) for d in depths]
    xyz_world_lst, conf_lst = [], []
    for ref in range(V):
        d_ref = ds[ref]
        H, W = d_ref.shape
        geo_sum = torch.zeros((H, W), dtype=torch.int32, device=dev)
        depth_sum = torch.zeros((H, W), device=dev)
        for src in range(V):
            if src == ref:
                continue
            geo, _vis, d_rep = check_geometric_consistency(
                d_ref, Ks[ref], Es[ref], ds[src], Ks[src], Es[src])
            geo_sum = geo_sum + geo.to(torch.int32)
            depth_sum = depth_sum + d_rep
        depth_avg = (depth_sum + d_ref) / (geo_sum + 1)
        conf_ref = t(confs[ref])
        final = conf_ref > depth_conf_thresh
        if masks is not None:
            final = final & t(masks[ref]).bool()
        if V > 1:
            final = final & (geo_sum >= geo_cnsst_num)

        final_np = final.cpu().numpy()
        ys, xs = np.nonzero(final_np)
        d = depth_avg.cpu().numpy()[ys, xs]
        pix = np.stack([xs, ys, np.ones_like(xs)], axis=0).astype(np.float64)
        cam = np.linalg.inv(np.asarray(intrinsics[ref])) @ (pix * d)
        cam_h = np.concatenate([cam, np.ones((1, cam.shape[1]))], axis=0)
        world = (np.linalg.inv(np.asarray(extrinsics[ref])) @ cam_h)[:3].T
        xyz_world_lst.append(world.astype(np.float32))
        conf_lst.append(conf_ref.cpu().numpy()[ys, xs].astype(np.float32))
    return xyz_world_lst, conf_lst
