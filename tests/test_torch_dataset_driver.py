"""The port's dataset driver (pointnerf_tpu_torch/train/driver.py
`train_dataset_scene`, `test_dataset_scene`, the `--dataset` CLI) against
the JAX package's on a generated NeRF-Synthetic scene, at the tiny config
of tests/test_dataset_driver.py (scene_config at vox_res 16, K 4, SR 8,
D 32; the bucket / shell-layered query, the dense f32 decode, the fused
flags off).

Both drivers get the same cloud, point features (carried in the cloud, as
a loader may give them) and MLP weights (JAX's init), and no ray jitter
(the two packages draw other numbers); the images are the loader's size
(the loaders' DataConfig defaults to 800 x 800, so the fixture's 20 x 16 is
set there). Bars: the per-step losses within 1e-3 relative, the eval and
test PSNR within 1e-2 dB."""
import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

import pointnerf_tpu.config as jcfg
import pointnerf_tpu.data.nerf_synth as jns
import pointnerf_tpu_torch.data.nerf_synth as tns
from pointnerf_tpu.train import driver as jd
from pointnerf_tpu_torch import config as tcfg
from pointnerf_tpu_torch.convert import params_from_jax
from pointnerf_tpu_torch.train import driver as td

CURVE_BAR = 1e-3
PSNR_BAR = 1e-2   # dB
WH = (20, 16)
STEPS = 10


@dataclasses.dataclass(frozen=True)
class _JaxData(jcfg.DataConfig):
    img_wh: tuple = WH


@dataclasses.dataclass(frozen=True)
class _PortData(tcfg.DataConfig):
    img_wh: tuple = WH


def _fixture_scene(root, n_views=3):
    """tests/test_dataset_driver.py's scene: random RGBA views on a ring
    at radius 3 (blender poses looking at the origin) and a 300-point
    cloud."""
    import imageio.v2 as imageio
    from pointnerf_tpu.data.ply import save_ply
    rng = np.random.RandomState(0)
    W, H = WH
    for split in ("train", "test"):
        frames = []
        for i in range(n_views):
            img = (rng.rand(H, W, 4) * 255).astype(np.uint8)
            os.makedirs(root / split, exist_ok=True)
            imageio.imwrite(str(root / split / f"r_{i}.png"), img)
            th = 2 * np.pi * i / n_views
            pose = np.eye(4)
            pose[:3, 3] = [3 * np.sin(th), 0.5, 3 * np.cos(th)]
            z = -pose[:3, 3] / np.linalg.norm(pose[:3, 3])
            x = np.cross([0, 1, 0], -z)
            x /= np.linalg.norm(x) + 1e-9
            y = np.cross(-z, x)
            pose[:3, 0], pose[:3, 1], pose[:3, 2] = x, y, -z
            frames.append({"file_path": f"{split}/r_{i}",
                           "transform_matrix": pose.tolist()})
        (root / f"transforms_{split}.json").write_text(json.dumps(
            {"camera_angle_x": 0.9, "frames": frames}))
    xyz = rng.normal(0, 0.3, (300, 3)).astype(np.float32)
    save_ply(str(root / "points.ply"), xyz, rng.rand(300, 3).astype(
        np.float32))


def _tiny_cfg(**train):
    cfg = jcfg.scene_config(
        np.random.RandomState(0).normal(0, 0.3, (300, 3)).astype(np.float32),
        vox_res=16, K=4, SR=8, z_depth_dim=32, near=2.0, far=4.5)
    t = dict(random_sample_size=6, maximum_step=STEPS, prune_iter=0,
             prob_freq=0, test_freq=STEPS, save_iter_freq=STEPS,
             print_freq=1)
    t.update(train)
    return cfg.replace(
        train=dataclasses.replace(cfg.train, **t),
        query=dataclasses.replace(cfg.query, max_o=4096, P=8,
                                  knn_chunk=2048),
        render=dataclasses.replace(cfg.render, train_jitter=0.0))


@pytest.fixture
def scene(tmp_path, monkeypatch):
    """The fixture on disk, the loaders at its image size, the same point
    features in both clouds and JAX's MLP init in the port."""
    _fixture_scene(tmp_path / "lego")
    monkeypatch.setattr(jcfg, "DataConfig", _JaxData)
    monkeypatch.setattr(td, "DataConfig", _PortData)
    feat = (np.random.RandomState(5).rand(300, 32) * 0.01).astype(np.float32)
    for mod in (jns, tns):
        real = mod.NerfSynthDataset.load_init_points

        def with_features(self, _real=real):
            return dict(_real(self), feature=feat)
        monkeypatch.setattr(mod.NerfSynthDataset, "load_init_points",
                            with_features)
    cfg = _tiny_cfg()
    _k1, k2, _k3 = jax.random.split(jax.random.PRNGKey(cfg.train.seed), 3)
    jparams = jax.tree.map(np.asarray, jd.init_mlp_params(k2, cfg))
    monkeypatch.setattr(td, "init_mlp_params", lambda _g, _c, device=None:
                        params_from_jax(jparams, device=device))
    return tmp_path


def test_train_and_test_dataset_scene_match_jax(scene, capsys):
    cfg = _tiny_cfg()
    pcfg = tcfg.PointNeRFConfig.from_json(cfg.to_json())
    js, _jst, jh = jd.train_dataset_scene(
        "nerf_synth360_ft", str(scene), "lego", run_dir=str(scene / "jrun"),
        max_steps=STEPS, cfg=cfg, resume=False)
    ts, _tst, th = td.train_dataset_scene(
        "nerf_synth360_ft", str(scene), "lego", run_dir=str(scene / "trun"),
        max_steps=STEPS, cfg=pcfg, resume=False, device="cpu")
    assert int(ts.step) == int(js.step) == STEPS
    lj = [v for _s, v in jh["loss"]]
    lt = [v for _s, v in th["loss"]]
    assert len(lt) == len(lj) == STEPS
    np.testing.assert_allclose(lt, lj, rtol=CURVE_BAR)
    assert len(th["eval"]) == len(jh["eval"]) == 1
    assert abs(th["eval"][0]["psnr"] - jh["eval"][0]["psnr"]) < PSNR_BAR
    mj = jd.test_dataset_scene("nerf_synth360_ft", str(scene), "lego",
                               run_dir=str(scene / "jrun"), cfg=cfg,
                               save_images=False)
    mt = td.test_dataset_scene("nerf_synth360_ft", str(scene), "lego",
                               run_dir=str(scene / "trun"), cfg=pcfg,
                               save_images=True, device="cpu")
    assert abs(mt["psnr"] - mj["psnr"]) < PSNR_BAR
    assert abs(mt["ssim"] - mj["ssim"]) < 1e-3
    # the whole test split (3 views) against the training run's eval
    # (every eighth view: view 0 only)
    assert len(os.listdir(scene / "trun" / "images")) == 3
    capsys.readouterr()


def test_dataset_cli_trains_then_tests(scene, monkeypatch, capsys):
    """`--dataset ... --device cpu` trains and checkpoints, `--test`
    evaluates the checkpoint. The CLI sizes its config from the cloud
    (scene_config); the test sizes that down to the tiny config."""
    small = tcfg.PointNeRFConfig.from_json(_tiny_cfg(
        save_iter_freq=0, test_freq=0).to_json())
    monkeypatch.setattr(td, "scene_config", lambda *a, **k: small)
    base = ["driver", "--dataset", "nerf_synth360_ft", "--data-root",
            str(scene), "--scan", "lego", "--run-dir", str(scene / "cli"),
            "--device", "cpu"]
    monkeypatch.setattr(sys, "argv", base + ["--steps", "3"])
    td.main()
    monkeypatch.setattr(sys, "argv", base + ["--test"])
    td.main()
    out = capsys.readouterr().out
    assert "[test] step 3: psnr=" in out and "over 3 frames" in out
    assert "ckpt_00000003" in os.listdir(scene / "cli")


def test_render_video_from_checkpoint(scene, monkeypatch, capsys):
    """`--video` renders the spiral path from the latest checkpoint into
    numbered PNG frames, each equal (after to8b) to render_full_frame of the
    restored state at that pose; a container without imageio raises."""
    from pointnerf_tpu_torch.data import find_dataset_class_by_name
    from pointnerf_tpu_torch.train.grow import render_full_frame
    from pointnerf_tpu_torch.utils.visualizer import Visualizer, read_png, to8b
    pcfg = tcfg.PointNeRFConfig.from_json(_tiny_cfg().to_json())
    run = str(scene / "vid")
    td.train_dataset_scene("nerf_synth360_ft", str(scene), "lego",
                           run_dir=run, max_steps=2, cfg=pcfg, resume=False,
                           device="cpu")
    out = td.render_video_from_checkpoint(
        "nerf_synth360_ft", str(scene), "lego", run, cfg=pcfg, n_frames=3,
        device="cpu")
    assert sorted(os.listdir(out)) == [f"frame_{i:05d}.png" for i in range(3)]
    ds = find_dataset_class_by_name("nerf_synth360_ft")(
        td.DataConfig(data_root=str(scene), scan="lego"), split="train")
    state, st, grid, _c = td._restore_latest(ds, run, pcfg, None,
                                             torch.device("cpu"))
    for i in (0, 2):
        maps = render_full_frame(state.params, st, grid, pcfg,
                                 ds.get_dummyrot_item(i, n_frames=3), WH,
                                 chunk=2304, prob=False)
        want = to8b(np.clip(maps["coarse_raycolor"][..., :3], 0, 1))
        np.testing.assert_array_equal(
            read_png(os.path.join(out, f"frame_{i:05d}.png")), want)
    monkeypatch.setattr(sys, "argv", [
        "driver", "--dataset", "nerf_synth360_ft", "--data-root", str(scene),
        "--scan", "lego", "--run-dir", run, "--video", "--device", "cpu"])
    calls = []
    monkeypatch.setattr(td, "render_video_from_checkpoint",
                        lambda *a, **k: calls.append((a, k)))
    td.main()
    assert calls == [(("nerf_synth360_ft", str(scene), "lego"),
                      {"run_dir": run, "device": "cpu"})]
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(RuntimeError, match="needs imageio"):
        Visualizer(run).gen_video([np.zeros((4, 4, 3))], "v", container="mp4")
    capsys.readouterr()
