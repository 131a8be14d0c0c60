"""The LLFF and ScanNet loaders of the port (pointnerf_tpu_torch/data/llff.py,
data/scannet.py) against the JAX package's, on generated PNG scenes (the
JAX loaders read them with imageio and resize depth with cv2, the port's
with its own PNG reader and a numpy nearest resize):
- every item of both splits equal, with the loaders' poses, intrinsics
  and near/far;
- ScanNet's load_init_points equal, its 16-bit depth resized to the color
  size; the nearest resize equal to cv2.INTER_NEAREST, down and up;
- read_png on 16-bit files equal to imageio's, on every filter type, and
  write_png's 16-bit files read back by both; write_png's row filters, 8-
  and 16-bit, read back by both;
- the ScanNet train split decodes a frame once and keeps it;
- a JPEG frame raises not_ported, naming the file."""
import os
import struct
import zlib

import numpy as np
import pytest

from pointnerf_tpu.config import DataConfig as JDataConfig
from pointnerf_tpu.data.llff import LlffDataset as JLlff
from pointnerf_tpu.data.scannet import ScannetDataset as JScannet
from pointnerf_tpu_torch import SliceNotPorted
from pointnerf_tpu_torch.config import DataConfig as TDataConfig
from pointnerf_tpu_torch.data.llff import LlffDataset as TLlff
from pointnerf_tpu_torch.data.scannet import ScannetDataset as TScannet
from pointnerf_tpu_torch.data.scannet import resize_nearest
from pointnerf_tpu_torch.utils.visualizer import read_png, write_png
from test_torch_data import _chunk


def _items_equal(t_ds, j_ds):
    assert len(t_ds) == len(j_ds) and len(t_ds) > 0
    for a in ("intrinsic", "near", "far", "height", "width"):
        np.testing.assert_array_equal(getattr(t_ds, a), getattr(j_ds, a),
                                      err_msg=a)
    for i in range(len(j_ds)):
        for kw in (dict(), dict(random_sample="random", random_sample_size=5,
                                seed=i + 3)):
            a, b = t_ds.get_item(i, **kw), j_ds.get_item(i, **kw)
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]), err_msg=k)


def _llff_scene(root, n=9, wh=(20, 16), factor=4, jpg_frame=None):
    import imageio.v2 as imageio
    rng = np.random.RandomState(0)
    W, H = wh
    d = os.path.join(root, f"images_{factor}")
    os.makedirs(d)
    rows = []
    for i in range(n):
        img = (rng.rand(H, W, 3) * 255).astype(np.uint8)
        ext = ".jpg" if i == jpg_frame else ".png"
        imageio.imwrite(os.path.join(d, f"IMG_{i:04d}{ext}"), img)
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        pose = np.concatenate([q, rng.normal(size=(3, 1)),
                               [[H * factor], [W * factor], [70.0 * factor]]],
                              1)
        rows.append(np.concatenate([pose.ravel(), rng.uniform(1, 2, 1),
                                    rng.uniform(5, 8, 1)]))
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))


@pytest.mark.parametrize("split", ["train", "test"])
def test_llff_items_match_jax(tmp_path, split):
    _llff_scene(str(tmp_path / "fern"))
    kw = dict(split=split, factor=4)
    t_ds = TLlff(TDataConfig(data_root=str(tmp_path), scan="fern"), **kw)
    j_ds = JLlff(JDataConfig(data_root=str(tmp_path), scan="fern"), **kw)
    assert len(t_ds) == (7 if split == "train" else 2)
    np.testing.assert_array_equal(t_ds.poses, j_ds.poses)
    _items_equal(t_ds, j_ds)


def _filtered_png16(path, img, filters):
    """A 16-bit grey (or RGB) PNG of img [H, W, C] uint16 whose row r is
    stored with filter type filters[r % len(filters)], on its big-endian
    bytes at 2C bytes a pixel."""
    h, w, c = img.shape
    raw = img.astype(">u2").view(np.uint8).reshape(h, w * c * 2).astype(
        np.int32)
    bpp = 2 * c
    out = bytearray()
    for r in range(h):
        ft = filters[r % len(filters)]
        cur = raw[r]
        up = raw[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul))
        pred = [0, left, up, (left + up) >> 1, paeth][ft]
        out.append(ft)
        out += ((cur - pred) & 255).astype(np.uint8).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16,
                                            {1: 0, 3: 2}[c], 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(bytes(out))))
        f.write(_chunk(b"IEND", b""))


def test_read_png_16_bit_equals_imageio(tmp_path):
    import imageio.v2 as imageio
    rng = np.random.RandomState(1)
    depth = np.concatenate([
        (rng.rand(7, 23) * 65535).astype(np.uint16),
        (np.arange(12 * 23).reshape(12, 23) * 211 % 9000).astype(np.uint16)])
    p = str(tmp_path / "io.png")
    imageio.imwrite(p, depth)
    got = read_png(p)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, imageio.imread(p))
    np.testing.assert_array_equal(got, depth)
    w = str(tmp_path / "w.png")          # the port's writer, 16-bit
    write_png(w, depth)
    np.testing.assert_array_equal(imageio.imread(w), depth)
    np.testing.assert_array_equal(read_png(w), depth)
    for c in (1, 3):
        img = (rng.rand(9, 11, c) * 65535).astype(np.uint16)
        q = str(tmp_path / f"f{c}.png")
        _filtered_png16(q, img, [0, 1, 2, 3, 4])
        want = img[..., 0] if c == 1 else img
        np.testing.assert_array_equal(read_png(q), want)
        if c == 1:      # imageio (Pillow) reads 16-bit RGB as 8-bit
            np.testing.assert_array_equal(read_png(q), imageio.imread(q))


@pytest.mark.parametrize("src,dst", [((480, 640), (968, 1296)),
                                     ((968, 1296), (480, 640)),
                                     ((7, 13), (5, 29)), ((12, 16), (36, 48))])
def test_resize_nearest_equals_cv2(src, dst):
    import cv2
    img = np.random.RandomState(2).rand(*src).astype(np.float32)
    np.testing.assert_array_equal(
        resize_nearest(img, dst[::-1]),
        cv2.resize(img, dst[::-1], interpolation=cv2.INTER_NEAREST))


def _scannet_scene(root, n=6, wh=(32, 24), dwh=(16, 12), jpg=False):
    import imageio.v2 as imageio
    rng = np.random.RandomState(3)
    for d in ("color", "depth", "pose", "intrinsic"):
        os.makedirs(os.path.join(root, d))
    W, H = wh
    K = np.array([[30.0, 0, W / 2, 0], [0, 30.0, H / 2, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]])
    np.savetxt(os.path.join(root, "intrinsic", "intrinsic_color.txt"), K)
    for i in range(n):
        ext = ".jpg" if jpg and i == 1 else ".png"
        imageio.imwrite(os.path.join(root, "color", f"{i}{ext}"),
                        (rng.rand(H, W, 3) * 255).astype(np.uint8))
        depth = (rng.uniform(500, 4000, dwh[::-1])).astype(np.uint16)
        depth[rng.rand(*dwh[::-1]) < 0.2] = 0
        imageio.imwrite(os.path.join(root, "depth", f"{i}.png"), depth)
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = q, rng.normal(size=3)
        np.savetxt(os.path.join(root, "pose", f"{i}.txt"), c2w)


@pytest.mark.parametrize("split", ["train", "test"])
def test_scannet_items_and_init_points_match_jax(tmp_path, split):
    _scannet_scene(str(tmp_path / "scene0000_00"))
    cfg = dict(data_root=str(tmp_path), scan="scene0000_00")
    t_ds = TScannet(TDataConfig(**cfg), split=split)
    j_ds = JScannet(JDataConfig(**cfg), split=split)
    assert t_ds.id_list == j_ds.id_list == ([1, 2, 3, 4] if split == "train"
                                            else [0, 5])
    _items_equal(t_ds, j_ds)
    for step in (1, 10):
        a, b = t_ds.load_init_points(step=step), j_ds.load_init_points(step=step)
        assert a["xyz"].shape[0] > 0
        for k in ("xyz", "color"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_jpeg_frames_raise_not_ported(tmp_path):
    _llff_scene(str(tmp_path / "fern"), jpg_frame=3)
    with pytest.raises(SliceNotPorted, match=r"JPEG frames .*IMG_0003\.jpg"):
        TLlff(TDataConfig(data_root=str(tmp_path), scan="fern"),
              split="train", factor=4)
    _scannet_scene(str(tmp_path / "scene0000_00"), jpg=True)
    cfg = TDataConfig(data_root=str(tmp_path), scan="scene0000_00")
    with pytest.raises(SliceNotPorted, match=r"Queue 1, datasets"):
        TScannet(cfg, split="train")
    ds = TScannet(cfg, split="test")          # frames 0 and 5: PNG
    assert len(ds) == 2
    with pytest.raises(SliceNotPorted, match=r"color/1\.jpg"):
        TScannet(cfg, split="train", step=1)


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("filters", [(0, 1, 2, 3, 4), (4,), (1, 2)])
def test_write_png_filters_read_back(tmp_path, depth, filters):
    """write_png stores each row with the filter asked for; imageio and
    read_png (the row-at-a-time path for None/Sub/Up only, the
    anti-diagonal path otherwise) read the image back."""
    import imageio.v2 as imageio
    from test_torch_data import _filter_types
    rng = np.random.RandomState(depth)
    top = 255 if depth == 8 else 65535
    dt = np.uint8 if depth == 8 else np.uint16
    yy, xx = np.mgrid[0:23, 0:37]
    smooth = ((xx * 7 + yy * 5) % (top + 1)).astype(dt)
    img = np.concatenate([(rng.rand(11, 37) * top).astype(dt), smooth[11:]])
    for c in (1, 3):
        a = img if c == 1 else np.stack([img, img[::-1], img[:, ::-1]], -1)
        p = str(tmp_path / f"w{c}.png")
        write_png(p, a, filters=filters)
        assert _filter_types(p) == set(filters)
        np.testing.assert_array_equal(read_png(p), a)
        if depth == 8 or c == 1:    # imageio (Pillow) reads 16-bit RGB as 8
            np.testing.assert_array_equal(imageio.imread(p), a)


def test_scannet_train_split_keeps_decoded_frames(tmp_path):
    """A train item's frame is decoded once and kept (the file is no longer
    read); the test split keeps none."""
    root = tmp_path / "scene0000_00"
    _scannet_scene(str(root))
    cfg = TDataConfig(data_root=str(tmp_path), scan="scene0000_00")
    test = TScannet(cfg, split="test")
    test.get_item(1)
    assert not test._frames
    train = TScannet(cfg, split="train")
    first = train.get_item(2)
    os.remove(root / "color" / f"{train.id_list[2]}.png")
    again = train.get_item(2)
    for k in first:
        np.testing.assert_array_equal(np.asarray(again[k]),
                                      np.asarray(first[k]), err_msg=k)
