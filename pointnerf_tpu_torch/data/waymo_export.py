"""Waymo frames -> the npz bundle `data/waymo.py` reads.

Counterpart of `pointnerf_tpu/data/waymo_export.py`, in two layers:
 - `frames_to_npz(frames, ...)`: numpy, with the LiDAR voxel downsample on
   the port's `ops/voxel.py` (on `device`). Camera-to-world poses remapped
   to the NeRF convention ([-y, z, -x, t] columns), intrinsics and images
   rescaled (images at `target_upscale` x the pose scale, by block mean for
   an integer factor, else bilinear), LiDAR points voxel-downsampled per
   frame, every `step`-th frame in the test split, and the center pixel's
   ray direction per frame.
 - `read_waymo_tfrecord(path)`: per-frame dicts from a Waymo Open Dataset
   TFRecord. It needs tensorflow and waymo_open_dataset, imported only
   when it is called: export the bundle where the raw records live.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Sequence

import numpy as np

from .. import DeviceLike
from ..camera import get_dtu_raydir

# the pose convention remap: columns [-y, z, -x, t] of camera-to-world
_NERF_COLS = ((1, -1.0), (2, 1.0), (0, -1.0))


def _remap_pose(c2w: np.ndarray) -> np.ndarray:
    cols = [c2w[:, i:i + 1] * s for i, s in _NERF_COLS]
    return np.concatenate(cols + [c2w[:, 3:4]], axis=1).astype(np.float32)


def frames_to_npz(frames: Iterable[Dict], out_path, step: int = 10,
                  scale_factor: float = 10.0, vox_res: int = 100,
                  target_upscale: int = 2,
                  device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """Assemble per-frame dicts into the waymo_ft bundle.

    frames: dicts with image [H, W, 3] float32 in [0, 1], c2w [4, 4], K
    [3, 3] (full resolution) and points_world [M, 3] or None. Every
    `step`-th frame is a test frame; poses and intrinsics scale by
    1 / scale_factor and the images render at target_upscale x that.
    A frame's points above vox_res are voxel-downsampled at vox_res^3 (on
    `device`, the card unless the caller asks for the CPU). Returns the
    bundle, also written to out_path unless it is None."""
    imgs, poses, pts, camposes, centerdirs = [], [], [], [], []
    K = None
    for f in frames:
        img = np.asarray(f["image"], np.float32)
        c2w = np.asarray(f["c2w"], np.float32)
        if K is None:
            K = np.asarray(f["K"], np.float32).copy()
            H, W = img.shape[:2]
        if f.get("points_world") is not None:
            p = np.asarray(f["points_world"], np.float32).reshape(-1, 3)
            if vox_res > 0 and p.shape[0] > vox_res:
                from ..ops.voxel import construct_vox_points_closest
                idx, _ = construct_vox_points_closest(p, vox_res,
                                                      device=device)
                p = p[np.asarray(idx)]
            pts.append(p)
        wh = (int(W // scale_factor), int(H // scale_factor))
        center = np.asarray(wh, np.float32)[None, :] // 2
        Ks = K / scale_factor
        Ks[2, 2] = 1.0
        centerdirs.append(get_dtu_raydir(center, Ks, c2w[:3, :3], True))
        camposes.append(c2w[:3, 3])
        poses.append(_remap_pose(c2w))
        th, tw = wh[1] * target_upscale, wh[0] * target_upscale
        imgs.append(_resize_area(img, th, tw))

    if K is None:
        raise ValueError("no frames to export")
    ids = list(range(len(imgs)))
    Ks = K / scale_factor
    Ks[2, 2] = 1.0
    # the bundle's intrinsic is that of the exported images
    Kb = Ks * target_upscale
    Kb[2, 2] = 1.0
    bundle = {
        "images": np.stack(imgs).astype(np.float32),
        "poses": np.stack(poses).astype(np.float32),
        "intrinsic": Kb.astype(np.float32),
        "hwf": np.asarray([imgs[0].shape[0], imgs[0].shape[1],
                           float(Kb[0, 0])], np.float32),
        "camposes": np.stack(camposes).astype(np.float32),
        "centerdirs": np.concatenate(centerdirs).astype(np.float32),
        "test_ids": np.asarray(ids[::step], np.int64),
        "train_ids": np.asarray([i for i in ids if i % step != 0], np.int64),
    }
    if pts:
        bundle["points_xyz_all"] = np.concatenate(pts).astype(np.float32)
    if out_path is not None:
        np.savez_compressed(out_path, **bundle)
    return bundle


def _resize_area(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    """[H, W, C] -> [th, tw, C]: the mean of each block for an integer
    down-scale factor (what cv2's INTER_AREA gives there), bilinear at
    pixel centers otherwise."""
    H, W = img.shape[:2]
    if H == th and W == tw:
        return img
    if H % th == 0 and W % tw == 0:
        fh, fw = H // th, W // tw
        return img[: th * fh, : tw * fw].reshape(
            th, fh, tw, fw, -1).mean(axis=(1, 3)).astype(np.float32)
    ys = np.clip((np.arange(th) + 0.5) * H / th - 0.5, 0, H - 1)
    xs = np.clip((np.arange(tw) + 0.5) * W / tw - 0.5, 0, W - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    out = (img[y0][:, x0] * (1 - wy) * (1 - wx)
           + img[y0][:, x1] * (1 - wy) * wx
           + img[y1][:, x0] * wy * (1 - wx)
           + img[y1][:, x1] * wy * wx)
    return out.astype(np.float32)


def read_waymo_tfrecord(path: str, frames_length: int = 30,
                        start_frame: int = 0, load_points: bool = True,
                        camera: int = 0) -> Iterable[Dict]:
    """Per-frame dicts (image, c2w, K, points_world) of one camera from a
    Waymo Open Dataset TFRecord: cameras sorted by name (0 = FRONT), the
    lens undistorted when cv2 is present, and the LiDAR points that project
    into that camera in world coordinates (none on every 10th frame)."""
    try:
        import tensorflow.compat.v1 as tf
        from waymo_open_dataset import dataset_pb2 as open_dataset
        from waymo_open_dataset.utils import frame_utils
    except ImportError as e:
        raise ImportError(
            "read_waymo_tfrecord needs `tensorflow` and "
            "`waymo_open_dataset`: export the npz bundle on a machine that "
            "has them; training itself only needs the bundle") from e
    try:
        import cv2
    except ImportError:
        cv2 = None

    tf.enable_eager_execution()
    dataset = tf.data.TFRecordDataset(path, compression_type="")
    K = dist = pose_cam2veh = None
    emitted = 0
    for index, data in enumerate(dataset):
        if index < start_frame:
            continue
        if frames_length != -1 and emitted >= frames_length:
            break
        emitted += 1
        frame = open_dataset.Frame()
        frame.ParseFromString(bytearray(data.numpy()))
        images_sorted = sorted(frame.images, key=lambda i: i.name)
        cam = images_sorted[camera]
        pose_veh2world = np.reshape(
            np.array(frame.pose.transform, np.float32), (4, 4))
        img = (np.array(tf.image.decode_jpeg(cam.image)) / 255.0
               ).astype(np.float32)
        if K is None:
            calib = sorted(frame.context.camera_calibrations,
                           key=lambda c: c.name)[camera]
            intr = calib.intrinsic
            K = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]],
                          [0, 0, 1]], np.float32)
            dist = np.asarray(intr[4:9], np.float32)
            pose_cam2veh = np.array(calib.extrinsic.transform,
                                    np.float32).reshape(4, 4)
        if cv2 is not None:
            img = cv2.undistort(img, K, dist, None, K)
        points_world = None
        if load_points and index % 10 != 0:
            ri, cp, top_pose = \
                frame_utils.parse_range_image_and_camera_projection(frame)
            points, cp_points = frame_utils.convert_range_image_to_point_cloud(
                frame, ri, cp, top_pose)
            pa = np.concatenate(points, axis=0).astype(np.float32)
            cpa = np.concatenate(cp_points, axis=0)
            mask = cpa[..., 0] == images_sorted[camera].name
            p_vehicle = pa[mask]
            points_world = (pose_veh2world[:3, :3] @ p_vehicle.T
                            + pose_veh2world[:3, 3][:, None]).T
        yield {"image": img, "c2w": pose_veh2world @ pose_cam2veh, "K": K,
               "points_world": points_world}


def export_sequences(tfrecords: Sequence[str], out_dir: str,
                     **kwargs) -> List[str]:
    """Export each TFRecord to its own npz bundle under out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    outs = []
    read_kw = {k: kwargs.pop(k) for k in
               ("frames_length", "start_frame", "load_points", "camera")
               if k in kwargs}
    for rec in tfrecords:
        name = os.path.splitext(os.path.basename(rec))[0] + ".npz"
        out = os.path.join(out_dir, name)
        frames_to_npz(read_waymo_tfrecord(rec, **read_kw), out, **kwargs)
        outs.append(out)
    return outs
