"""The port's data layer against the JAX package's: the PNG reader (against
imageio), the block-mean resize (against OpenCV's INTER_AREA), PLY I/O, the
procedural scenes, the camera helpers, scene_config / ranges_from_cloud /
the presets, the dataset registry, NerfSynthDataset items on a generated
fixture, the voxel downsample and the image-folder metrics CLI. imageio
and cv2 exist in this environment only as references; the port reads and
writes images with the standard library."""
import dataclasses
import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _filtered_png(path, img, filters):
    """An 8-bit PNG of img [H, W, C] whose row r is stored with filter type
    filters[r % len(filters)] (encoded as the PNG specification defines)."""
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    raw = img.reshape(h, w * c).astype(np.int32)
    out = bytearray()
    for r in range(h):
        ft = filters[r % len(filters)]
        cur = raw[r]
        up = raw[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(ft)
        out += ((cur - pred) & 255).astype(np.uint8).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                            0)))
        f.write(_chunk(b"IDAT", zlib.compress(bytes(out))))
        f.write(_chunk(b"IEND", b""))


def _filter_types(path):
    data = open(path, "rb").read()
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        if tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(hdr[1], -1)
    return set(raw[:, 0].tolist())


def _images(rng, h=19, w=23):
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([(xx * 9) % 256, (yy * 7) % 256, (xx * yy) % 256,
                       (xx + 2 * yy) % 256], -1).astype(np.uint8)
    noisy = (rng.rand(h, w, 4) * 255).astype(np.uint8)
    return [np.concatenate([noisy[:h // 2], smooth[h // 2:]])[..., :c]
            for c in (1, 2, 3, 4)]


def test_read_png_equals_imageio(tmp_path):
    """Files imageio writes (grey, RGB, RGBA; its encoder picks filters 0,
    1, 2 and 4 on these) and files with every filter type 0-4 on rotating
    rows (grey, grey+alpha, RGB, RGBA): read_png gives imageio's arrays."""
    import imageio.v2 as imageio
    from pointnerf_tpu_torch.utils.visualizer import read_png, write_png
    rng = np.random.RandomState(0)
    seen = set()
    for i, img in enumerate(_images(rng)):
        a = img[..., 0] if img.shape[-1] == 1 else img
        if img.shape[-1] != 2:          # imageio writes no grey+alpha
            p = str(tmp_path / f"io{i}.png")
            imageio.imwrite(p, a)
            seen |= _filter_types(p)
            got = read_png(p)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, imageio.imread(p))
        q = str(tmp_path / f"f{i}.png")
        _filtered_png(q, img, [0, 1, 2, 3, 4])
        assert _filter_types(q) == {0, 1, 2, 3, 4}
        np.testing.assert_array_equal(read_png(q), imageio.imread(q))
        np.testing.assert_array_equal(read_png(q), a)
        w = str(tmp_path / f"w{i}.png")
        write_png(w, a)
        np.testing.assert_array_equal(read_png(w), a)
    assert seen >= {0, 1, 2, 4}


def test_read_png_refuses_other_formats(tmp_path):
    import imageio.v2 as imageio
    from pointnerf_tpu_torch.utils.visualizer import read_png
    p16 = str(tmp_path / "d16.png")
    imageio.imwrite(p16, (np.arange(40).reshape(5, 8) * 1000).astype(np.uint16))
    with pytest.raises(ValueError, match="8-bit"):
        read_png(p16)
    jpg = str(tmp_path / "x.jpg")
    imageio.imwrite(jpg, np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(jpg)


@pytest.mark.parametrize("factor", [2, 4, 5])
def test_block_mean_resize_equals_inter_area(factor):
    import cv2
    from pointnerf_tpu_torch.data.nerf_synth import block_mean_resize
    rng = np.random.RandomState(factor)
    im = rng.rand(16 * factor, 12 * factor, 4).astype(np.float32)
    ref = cv2.resize(im, (12, 16), interpolation=cv2.INTER_AREA)
    np.testing.assert_allclose(block_mean_resize(im, (12, 16)), ref,
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="integer down-scale"):
        block_mean_resize(im, (11, 16))


def test_ply_round_trip_with_the_jax_loader(tmp_path):
    from pointnerf_tpu.data import ply as jply
    from pointnerf_tpu_torch.data import ply as tply
    rng = np.random.RandomState(0)
    xyz = rng.randn(57, 3).astype(np.float32)
    col = rng.rand(57, 3).astype(np.float32)
    for save, load in ((tply.save_ply, jply.load_ply),
                       (jply.save_ply, tply.load_ply)):
        p = str(tmp_path / "c.ply")
        save(p, xyz, col)
        a, b = load(p), tply.load_ply(p)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(b["xyz"], xyz)
    asc = tmp_path / "a.ply"
    asc.write_text("ply\nformat ascii 1.0\nelement vertex 2\nproperty float x"
                   "\nproperty float y\nproperty float z\nproperty float nx\n"
                   "property float ny\nproperty float nz\nend_header\n"
                   "1 2 3 0 0 1\n4 5 6 1 0 0\n")
    a, b = jply.load_ply(str(asc)), tply.load_ply(str(asc))
    assert sorted(a) == sorted(b) == ["normal", "xyz"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", ["cluster", "thicket"])
def test_procedural_arrays_equal_jax(name):
    from pointnerf_tpu.data import procedural as jp
    from pointnerf_tpu_torch.data import procedural as tp
    assert sorted(tp.SCENES) == sorted(jp.SCENES)
    pj, pt = jp.SCENES[name](), tp.SCENES[name]()
    for a, b in zip(jp.sample_cloud(pj, 3000, seed=2),
                    tp.sample_cloud(pt, 3000, seed=2)):
        np.testing.assert_array_equal(a, b)
    vj = jp.sphere_cameras(5, seed=1, wh=(40, 30), focal=44.0)
    vt = tp.sphere_cameras(5, seed=1, wh=(40, 30), focal=44.0)
    for a, b in zip(vj, vt):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for kw in (dict(n_rays=300, seed=4), dict()):
        ij = jp.view_item(pj, *vj[2], (40, 30), view_id=2, **kw)
        it = tp.view_item(pt, *vt[2], (40, 30), view_id=2, **kw)
        assert sorted(ij) == sorted(it)
        for k in ij:
            np.testing.assert_array_equal(np.asarray(it[k]),
                                          np.asarray(ij[k]), err_msg=k)


def test_camera_helpers_equal_jax():
    from pointnerf_tpu import camera as jc
    from pointnerf_tpu_torch import camera as tcam
    np.testing.assert_array_equal(tcam.BLENDER2OPENCV, jc.BLENDER2OPENCV)
    for th, ph, r in ((-180.0, -30.0, 4.0), (37.5, 12.0, 2.5)):
        np.testing.assert_array_equal(tcam.pose_spherical(th, ph, r),
                                      jc.pose_spherical(th, ph, r))
    rng = np.random.RandomState(0)
    pix = rng.randint(0, 40, (50, 2)).astype(np.float32)
    rot = jc.pose_spherical(20.0, -15.0, 3.0)[:3, :3]
    for norm in (False, True):
        np.testing.assert_array_equal(
            tcam.get_blender_raydir(pix, 30, 40, 35.0, rot, norm),
            jc.get_blender_raydir(pix, 30, 40, 35.0, rot, norm))
    t = tcam.get_blender_raydir(torch.from_numpy(pix), 30, 40, 35.0,
                                torch.from_numpy(rot), True)
    np.testing.assert_allclose(t.numpy(), jc.get_blender_raydir(
        pix, 30, 40, 35.0, rot, True), rtol=1e-6, atol=1e-7)


def _json(cfg):
    return json.loads(cfg.to_json())


def test_scene_config_and_presets_equal_jax():
    from pointnerf_tpu import config as jcfg
    from pointnerf_tpu import presets as jpre
    from pointnerf_tpu_torch import config as tcfg
    from pointnerf_tpu_torch import presets as tpre
    xyz = np.random.RandomState(0).normal(0, 0.3, (300, 3)).astype(np.float32)
    assert tcfg.ranges_from_cloud(xyz) == jcfg.ranges_from_cloud(xyz)
    assert tcfg.ranges_from_cloud(xyz, 0.2) == jcfg.ranges_from_cloud(xyz,
                                                                      0.2)
    for kw in (dict(), dict(vox_res=16, K=4, SR=8, z_depth_dim=32, near=2.0,
                            far=4.5)):
        assert _json(tcfg.scene_config(xyz, **kw)) == _json(
            jcfg.scene_config(xyz, **kw))
    assert tpre.SCENE_PRESETS == jpre.SCENE_PRESETS
    for name in jpre.SCENE_PRESETS:
        for kw in (dict(), dict(fused_decode=False, compute_dtype="f32")):
            assert _json(tpre.scene_preset(name, **kw)) == _json(
                jpre.scene_preset(name, **kw)), name
        assert tpre.preset_mvs_init_kwargs(name) == \
            jpre.preset_mvs_init_kwargs(name)
    with pytest.raises(KeyError):
        tpre.scene_preset("nerf_synth/nope")
    assert [f.name for f in dataclasses.fields(tcfg.DataConfig)] == \
        [f.name for f in dataclasses.fields(jcfg.DataConfig)]


def test_dataset_registry():
    from pointnerf_tpu_torch import SliceNotPorted
    from pointnerf_tpu_torch.data import find_dataset_class_by_name
    from pointnerf_tpu_torch.data.nerf_synth import NerfSynthDataset
    for name in ("nerf_synth360_ft", "nerf_synth_ft"):
        assert find_dataset_class_by_name(name) is NerfSynthDataset
    from pointnerf_tpu_torch.data.nsvf import NsvfDataset
    from pointnerf_tpu_torch.data.waymo import WaymoDataset
    for name in ("tt_ft", "nsvf"):
        assert find_dataset_class_by_name(name) is NsvfDataset
    assert find_dataset_class_by_name("waymo_ft") is WaymoDataset
    from pointnerf_tpu_torch.data.dtu import DtuDataset
    from pointnerf_tpu_torch.data.dtu_ft import DtuFtDataset
    assert find_dataset_class_by_name("dtu") is DtuDataset
    assert find_dataset_class_by_name("dtu_ft") is DtuFtDataset
    for name in ("llff_ft", "scannet_ft"):
        with pytest.raises(SliceNotPorted, match="Queue 1, datasets"):
            find_dataset_class_by_name(name)
    with pytest.raises(KeyError):
        find_dataset_class_by_name("nope")


def _nerf_synth_fixture(root, wh=(20, 16), scale=1):
    """The fixture of tests/test_datasets.py::test_nerf_synth_dataset
    (three RGBA views of random pixels, poses on +z), written with
    imageio, at `scale` times the loader's size; a points.ply beside it."""
    import imageio.v2 as imageio
    from pointnerf_tpu.data.ply import save_ply
    rng = np.random.RandomState(0)
    W, H = wh
    frames = []
    for i in range(3):
        img = (rng.rand(H * scale, W * scale, 4) * 255).astype(np.uint8)
        os.makedirs(root / "train", exist_ok=True)
        imageio.imwrite(str(root / "train" / f"r_{i}.png"), img)
        pose = np.eye(4)
        pose[2, 3] = 4.0 + i
        frames.append({"file_path": f"train/r_{i}",
                       "transform_matrix": pose.tolist()})
    (root / "transforms_train.json").write_text(json.dumps(
        {"camera_angle_x": 0.69, "frames": frames}))
    save_ply(str(root / "points.ply"),
             rng.randn(40, 3).astype(np.float32),
             rng.rand(40, 3).astype(np.float32))


@pytest.mark.parametrize("scale", [1, 2])
def test_nerf_synth_items_equal_jax(tmp_path, scale):
    """Every item the loader gives, against the JAX loader on the same
    files: equal, except that a 2x-sized image is shrunk by the block mean
    here and by cv2's INTER_AREA there (within 1e-6)."""
    from pointnerf_tpu.config import DataConfig as JDC
    from pointnerf_tpu.data import find_dataset_class_by_name as jfind
    from pointnerf_tpu_torch.config import DataConfig as TDC
    from pointnerf_tpu_torch.data import find_dataset_class_by_name as tfind
    _nerf_synth_fixture(tmp_path / "lego", scale=scale)
    kw = dict(dataset_name="nerf_synth360_ft", data_root=str(tmp_path),
              scan="lego", img_wh=(20, 16))
    dj = jfind("nerf_synth360_ft")(JDC(**kw), split="train")
    dt = tfind("nerf_synth360_ft")(TDC(**kw), split="train")
    assert len(dt) == len(dj) == 3
    tol = 0 if scale == 1 else 1e-6
    items = [(dj.get_item(i, random_sample=rs, random_sample_size=4, seed=s),
              dt.get_item(i, random_sample=rs, random_sample_size=4, seed=s))
             for i, rs, s in ((0, "random", 3), (1, "patch", None),
                              (2, "no_crop", None))]
    items.append((dj.get_dummyrot_item(3), dt.get_dummyrot_item(3)))
    for a, b in items:
        assert sorted(a) == sorted(b)
        for k in a:
            if a[k] is None or isinstance(a[k], (int, float)):
                assert a[k] == b[k], k
            else:
                np.testing.assert_allclose(np.asarray(b[k]),
                                           np.asarray(a[k]), rtol=0,
                                           atol=tol, err_msg=k)
    for k, v in dj.load_init_points().items():
        np.testing.assert_array_equal(dt.load_init_points()[k], v)


def test_construct_vox_points_closest_ids_equal_jax():
    from pointnerf_tpu.ops.voxel import construct_vox_points_closest as jv
    from pointnerf_tpu_torch.ops.voxel import \
        construct_vox_points_closest as tv
    rng = np.random.RandomState(0)
    for n, res in ((5000, 16), (40000, 64)):
        xyz = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
        xyz[::7] = xyz[::7].round(2)        # exact ties inside voxels
        ij, cj = jv(xyz, res)
        it, ct = tv(xyz, res, device="cpu")
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(ct, cj)
        it2, _ = tv(torch.from_numpy(xyz), res, device="cpu")
        np.testing.assert_array_equal(it2, ij)


def test_eval_cli_equals_jax(tmp_path, monkeypatch, capsys):
    """The image-folder metrics of both CLIs on the same PNGs."""
    import imageio.v2 as imageio
    from pointnerf_tpu import eval_cli as jcli
    from pointnerf_tpu_torch import eval_cli as tcli
    rng = np.random.RandomState(0)
    for d in ("pred", "gt", "out_j", "out_t"):
        os.makedirs(tmp_path / d)
    for i in range(3):
        g = (rng.rand(24, 20, 3) * 255).astype(np.uint8)
        p = np.clip(g.astype(np.int32) + rng.randint(-9, 10, g.shape), 0,
                    255).astype(np.uint8)
        imageio.imwrite(str(tmp_path / "gt" / f"{i}.png"), g)
        imageio.imwrite(str(tmp_path / "pred" / f"{i}.png"), p)
    metrics = ["psnr", "ssim", "rmse", "lpips_proxy"]
    monkeypatch.setattr(sys, "argv", [
        "eval_cli", "--pred", str(tmp_path / "pred"), "--gt",
        str(tmp_path / "gt"), "--metrics", *metrics, "--out",
        str(tmp_path / "out_j")])
    jcli.main()
    tcli.main(["--pred", str(tmp_path / "pred"), "--gt",
               str(tmp_path / "gt"), "--metrics", *metrics, "--out",
               str(tmp_path / "out_t")])
    for m in metrics + ["scores"]:
        assert (tmp_path / "out_t" / f"{m}.txt").read_text() == \
            (tmp_path / "out_j" / f"{m}.txt").read_text(), m
    capsys.readouterr()
