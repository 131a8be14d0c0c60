"""JPEG frames in the port (`utils/visualizer.read_jpeg` / `read_image`)
against imageio.v2.imread, which the JAX loaders read them with, on files
written here with Pillow: baseline 4:2:0 and 4:4:4, progressive, grayscale,
CMYK and a frame with an EXIF orientation tag, uint8 for uint8; and the
ScanNet and LLFF loaders' items on a scene of JPEG frames against the JAX
loaders'."""
import os

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from pointnerf_tpu.config import DataConfig as JDataConfig
from pointnerf_tpu.data.llff import LlffDataset as JLlff
from pointnerf_tpu.data.scannet import ScannetDataset as JScannet
from pointnerf_tpu_torch.config import DataConfig as TDataConfig
from pointnerf_tpu_torch.data.llff import LlffDataset as TLlff
from pointnerf_tpu_torch.data.scannet import ScannetDataset as TScannet
from pointnerf_tpu_torch.utils.visualizer import read_image, read_jpeg
from test_torch_llff_scannet import _items_equal, _llff_scene, _scannet_scene


def _exif(orientation: int):
    ex = Image.Exif()
    ex[0x0112] = orientation
    return ex


# name: (mode, save keywords)
CASES = {
    "baseline_420": ("RGB", dict(quality=90)),
    "baseline_444": ("RGB", dict(quality=90, subsampling=0)),
    "progressive": ("RGB", dict(quality=85, progressive=True)),
    "grayscale": ("L", dict(quality=90)),
    "cmyk": ("CMYK", dict(quality=90)),
    "exif_rotated": ("RGB", dict(quality=90, exif=_exif(6))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_read_jpeg_equals_imageio(tmp_path, name):
    mode, kw = CASES[name]
    rng = np.random.RandomState(len(name))
    # odd sizes, so that 4:2:0's chroma planes have a ragged edge
    a = (rng.rand(37, 53, len(mode)) * 255).astype(np.uint8)
    img = Image.fromarray(a[..., 0] if mode == "L" else a, mode=mode)
    path = str(tmp_path / f"{name}.jpg")
    img.save(path, **kw)
    ref = imageio.imread(path)
    got = read_jpeg(path)
    assert got.dtype == ref.dtype == np.uint8
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(read_image(path), ref)
    if name == "exif_rotated":          # the tag is left, as imageio does
        assert got.shape[:2] == (37, 53)


def _jpeg_scenes(root):
    """The LLFF and ScanNet scenes of test_torch_llff_scannet with every
    colour frame re-saved as JPEG."""
    _llff_scene(os.path.join(root, "fern"))
    _scannet_scene(os.path.join(root, "scene0000_00"))
    for d in (os.path.join(root, "fern", "images_4"),
              os.path.join(root, "scene0000_00", "color")):
        for f in sorted(os.listdir(d)):
            p = os.path.join(d, f)
            Image.open(p).convert("RGB").save(p[:-4] + ".jpg", quality=92)
            os.remove(p)


@pytest.mark.parametrize("split", ["train", "test"])
def test_loaders_on_jpeg_scenes_match_jax(tmp_path, split):
    _jpeg_scenes(str(tmp_path))
    lcfg = dict(data_root=str(tmp_path), scan="fern")
    t_ds = TLlff(TDataConfig(**lcfg), split=split, factor=4)
    j_ds = JLlff(JDataConfig(**lcfg), split=split, factor=4)
    np.testing.assert_array_equal(t_ds.images, j_ds.images)
    _items_equal(t_ds, j_ds)
    scfg = dict(data_root=str(tmp_path), scan="scene0000_00")
    t_ds = TScannet(TDataConfig(**scfg), split=split)
    j_ds = JScannet(JDataConfig(**scfg), split=split)
    _items_equal(t_ds, j_ds)
    a, b = t_ds.load_init_points(step=1), j_ds.load_init_points(step=1)
    assert a["xyz"].shape[0] > 0
    for k in ("xyz", "color"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
