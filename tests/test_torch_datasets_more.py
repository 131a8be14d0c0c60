"""The port's NSVF and Waymo loaders and the Waymo exporter
(pointnerf_tpu_torch/data/nsvf.py, waymo.py, waymo_export.py) against the
JAX package's, on scenes generated under tmp_path:

- tt_ft / nsvf: items, near / far and the init cloud equal to JAX's
  NsvfDataset, with RGBA and RGB PNGs and both intrinsics forms (a 4x4
  matrix and an "f cx cy" line), with and without a bbox;
- waymo_ft: items and the cloud equal to JAX's WaymoDataset; a
  multi-sequence scene raises;
- frames_to_npz: the bundle equal to JAX's, key for key (the LiDAR voxel
  downsample on the port's ops/voxel.py, on the CPU);
- train_dataset_scene --dataset tt_ft for a few steps against JAX's (the
  config and bars of tests/test_torch_dataset_driver.py)."""
import os

import jax
import numpy as np
import pytest

import pointnerf_tpu.data.nsvf as jnsvf
import pointnerf_tpu_torch.data.nsvf as tnsvf
from pointnerf_tpu.config import DataConfig as JData
from pointnerf_tpu.data import find_dataset_class_by_name as j_find
from pointnerf_tpu.data.waymo_export import frames_to_npz as j_export
from pointnerf_tpu.train import driver as jd
from pointnerf_tpu_torch import config as tcfg
from pointnerf_tpu_torch.config import DataConfig as TData
from pointnerf_tpu_torch.convert import params_from_jax
from pointnerf_tpu_torch.data import find_dataset_class_by_name as t_find
from pointnerf_tpu_torch.data.waymo_export import frames_to_npz as t_export
from pointnerf_tpu_torch.train import driver as td
from test_torch_dataset_driver import CURVE_BAR, PSNR_BAR, STEPS, _tiny_cfg

WH = (20, 16)


def _look_at(pos):
    """OpenCV camera-to-world looking at the origin from `pos`."""
    z = -np.asarray(pos, np.float64) / np.linalg.norm(pos)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, pos
    return c2w


def nsvf_scene(root, intrinsics="matrix", bbox=True, rgba=(0, 2),
               n_views=(3, 0, 2), n_pts=300, seed=0):
    """An NSVF-layout scene: rgb/<split>_<i>.png (RGBA for the view numbers
    in `rgba`, else RGB), pose/*.txt on a ring at radius 3, intrinsics.txt
    as a 4x4 matrix or an "f cx cy" line, bbox.txt and points.ply."""
    import imageio.v2 as imageio
    from pointnerf_tpu.data.ply import save_ply
    rng = np.random.RandomState(seed)
    W, H = WH
    os.makedirs(root / "rgb")
    os.makedirs(root / "pose")
    k = 0
    for split, n in enumerate(n_views):
        for i in range(n):
            stem = f"{split}_{i:04d}"
            ch = 4 if k in rgba else 3
            img = (rng.rand(H, W, ch) * 255).astype(np.uint8)
            imageio.imwrite(str(root / "rgb" / f"{stem}.png"), img)
            th = 2 * np.pi * k / sum(n_views)
            pos = [3 * np.sin(th), 0.4, 3 * np.cos(th)]
            np.savetxt(root / "pose" / f"{stem}.txt", _look_at(pos))
            k += 1
    if intrinsics == "matrix":
        K = np.eye(4)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 24.0, 24.0, W / 2, H / 2
        np.savetxt(root / "intrinsics.txt", K)
    else:
        (root / "intrinsics.txt").write_text(f"24.0 {W / 2} {H / 2} 0.\n")
    if bbox:
        (root / "bbox.txt").write_text("-0.8 -0.7 -0.9 0.8 0.75 0.85 0.01\n")
    xyz = rng.normal(0, 0.3, (n_pts, 3)).astype(np.float32)
    save_ply(str(root / "points.ply"), xyz,
             rng.rand(n_pts, 3).astype(np.float32))


def _same_item(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("intrinsics,bbox", [("matrix", True),
                                              ("line", True),
                                              ("line", False)])
def test_nsvf_items_match_jax(tmp_path, intrinsics, bbox):
    nsvf_scene(tmp_path / "scan", intrinsics=intrinsics, bbox=bbox)
    for name in ("tt_ft", "nsvf"):
        for split in ("train", "test"):
            dj = j_find(name)(JData(data_root=str(tmp_path), scan="scan"),
                              split=split)
            dt = t_find(name)(TData(data_root=str(tmp_path), scan="scan"),
                              split=split)
            assert len(dt) == len(dj) == (3 if split == "train" else 2)
            assert (dt.near, dt.far) == (dj.near, dj.far)
            np.testing.assert_array_equal(dt.images, dj.images)
            np.testing.assert_array_equal(dt.intrinsic, dj.intrinsic)
            for i in range(len(dt)):
                _same_item(dt.get_item(i), dj.get_item(i))
                for mode in ("random", "patch"):
                    _same_item(dt.get_item(i, mode, 6, seed=i + 3),
                               dj.get_item(i, mode, 6, seed=i + 3))
            _same_item(dt.load_init_points(), dj.load_init_points())
    # the RGBA views were composited on the background (white)
    d = t_find("nsvf")(TData(data_root=str(tmp_path), scan="scan"),
                       split="train")
    assert d.images.shape == (3, WH[1], WH[0], 3)
    assert 0.0 <= float(d.images.min()) and float(d.images.max()) <= 1.0


def _frames(n=12, H=40, W=60):
    rng = np.random.RandomState(0)
    K = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]],
                 np.float32)
    frames = []
    for i in range(n):
        c2w = _look_at([np.sin(0.1 * i) * 3, 0.3, np.cos(0.1 * i) * 3]
                       ).astype(np.float32)
        pts = (rng.randn(400, 3).astype(np.float32) * 0.5
               if i % 10 != 0 else None)
        frames.append({"image": rng.rand(H, W, 3).astype(np.float32),
                       "c2w": c2w, "K": K, "points_world": pts})
    return frames


@pytest.mark.parametrize("scale,up", [(4.0, 2), (3.0, 2)])
def test_frames_to_npz_matches_jax(tmp_path, scale, up):
    """The bundle key for key: the integer block mean (scale 4) and the
    bilinear resize (scale 3, a factor of 1.5), the voxel downsample."""
    frames = _frames()
    bj = j_export(frames, str(tmp_path / "j.npz"), step=10,
                  scale_factor=scale, vox_res=16, target_upscale=up)
    bt = t_export(frames, str(tmp_path / "t.npz"), step=10,
                  scale_factor=scale, vox_res=16, target_upscale=up,
                  device="cpu")
    assert set(bt) == set(bj)
    for k in bj:
        np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
    assert bt["points_xyz_all"].shape[0] < 11 * 400        # downsampled
    on_disk = np.load(tmp_path / "t.npz")
    assert set(on_disk.files) == set(bt)


def test_waymo_items_match_jax(tmp_path):
    frames = _frames()
    j_export(frames, str(tmp_path / "seq0.npz"), step=10, scale_factor=4.0,
             vox_res=16)
    for split in ("train", "test"):
        dj = j_find("waymo_ft")(JData(data_root=str(tmp_path), scan="seq0"),
                                split=split)
        dt = t_find("waymo_ft")(TData(data_root=str(tmp_path), scan="seq0"),
                                split=split)
        assert len(dt) == len(dj) == (10 if split == "train" else 2)
        assert dt.id_list == dj.id_list
        assert (dt.near, dt.far) == (dj.near, dj.far)
        for i in range(len(dt)):
            _same_item(dt.get_item(i, seed=i), dj.get_item(i, seed=i))
            _same_item(dt.get_item(i, "no_crop"), dj.get_item(i, "no_crop"))
        _same_item(dt.load_init_points(), dj.load_init_points())
    # a scene of several sequences: one dataset each, as JAX loads them
    from pointnerf_tpu.data.waymo import load_multiseq as j_multi
    from pointnerf_tpu_torch.data.waymo import load_multiseq
    ts = load_multiseq(TData(data_root=str(tmp_path)), ["seq0", "seq0"])
    js = j_multi(JData(data_root=str(tmp_path)), ["seq0", "seq0"])
    assert len(ts) == len(js) == 2
    for dt, dj in zip(ts, js):
        assert dt.id_list == dj.id_list
        _same_item(dt.get_item(0, seed=0), dj.get_item(0, seed=0))


@pytest.fixture
def tt_scene(tmp_path, monkeypatch):
    """An NSVF scene with the same point features in both clouds and JAX's
    MLP init in the port."""
    nsvf_scene(tmp_path / "scan", rgba=(0,), n_views=(3, 0, 1))
    feat = (np.random.RandomState(5).rand(300, 32) * 0.01).astype(np.float32)
    for mod in (jnsvf, tnsvf):
        real = mod.NsvfDataset.load_init_points

        def with_features(self, _real=real):
            return dict(_real(self), feature=feat)
        monkeypatch.setattr(mod.NsvfDataset, "load_init_points",
                            with_features)
    cfg = _tiny_cfg()
    _k1, k2, _k3 = jax.random.split(jax.random.PRNGKey(cfg.train.seed), 3)
    jparams = jax.tree.map(np.asarray, jd.init_mlp_params(k2, cfg))
    monkeypatch.setattr(td, "init_mlp_params", lambda _g, _c, device=None:
                        params_from_jax(jparams, device=device))
    return tmp_path


def test_train_dataset_scene_tt_ft_matches_jax(tt_scene, capsys):
    cfg = _tiny_cfg()
    pcfg = tcfg.PointNeRFConfig.from_json(cfg.to_json())
    js, _jst, jh = jd.train_dataset_scene(
        "tt_ft", str(tt_scene), "scan", run_dir=str(tt_scene / "jrun"),
        max_steps=STEPS, cfg=cfg, resume=False)
    ts, _tst, th = td.train_dataset_scene(
        "tt_ft", str(tt_scene), "scan", run_dir=str(tt_scene / "trun"),
        max_steps=STEPS, cfg=pcfg, resume=False, device="cpu")
    assert int(ts.step) == int(js.step) == STEPS
    lj = [v for _s, v in jh["loss"]]
    lt = [v for _s, v in th["loss"]]
    assert len(lt) == len(lj) == STEPS
    np.testing.assert_allclose(lt, lj, rtol=CURVE_BAR)
    assert len(th["eval"]) == len(jh["eval"]) == 1
    assert abs(th["eval"][0]["psnr"] - jh["eval"][0]["psnr"]) < PSNR_BAR
    capsys.readouterr()
