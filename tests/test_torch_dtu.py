"""The port's DTU loaders (pointnerf_tpu_torch/data/dtu.py, dtu_ft.py) and
its MVS-initialized dataset driver (`mvs_init_cloud`, `train_dataset_scene`
and `test_dataset_scene` with `--dataset dtu` / `dtu_ft`, and
`train_feedforward_dataset` / `--ff-dataset`) against the JAX package's,
on tests/test_datasets.py's and tests/test_dataset_driver.py's generated
fixtures (three random 32 x 32 views in DTU's layout).

Both drivers get the same MvsPointsInit variables (a seeded fill of flax's
tree, tests/test_torch_mvs.py, carried across by `convert`) and MLP
weights (JAX's init), and no ray jitter. Bars: items equal; the MVS cloud's
point count equal and its points within 1e-5 of scale; the per-step losses
within 1e-3 relative; the eval PSNR within 1e-2 dB.
"""
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

import pointnerf_tpu.config as jcfg
from pointnerf_tpu.data import find_dataset_class_by_name as jfind
from pointnerf_tpu.train import driver as jd
from pointnerf_tpu_torch import config as tcfg
from pointnerf_tpu_torch.convert import mvs_variables_from_jax, params_from_jax
from pointnerf_tpu_torch.data import find_dataset_class_by_name as tfind
from pointnerf_tpu_torch.train import driver as td
from test_torch_mvs import jax_mvs_variables

CURVE_BAR = 1e-3
PSNR_BAR = 1e-2   # dB
POINT_TOL = 1e-5
STEPS = 3


def _write_png(path, arr):
    import imageio.v2 as imageio
    os.makedirs(os.path.dirname(path), exist_ok=True)
    imageio.imwrite(path, arr)


def dtu_fixture(root, ft: bool, depth_line: str, size=(16, 20),
                K="25 0 10\n0 25 8\n0 0 1"):
    """tests/test_datasets.py's DTU (ft=False) or dtu_ft (ft=True) layout:
    three views shifted along x (200x in the dtu_ft cam files, which the
    loader scales by 1/200), a pair file, the finetune init pairs."""
    rng = np.random.RandomState(0)
    cams = root / "Cameras"
    os.makedirs(cams / "train", exist_ok=True)
    if ft:
        (cams / "pair.txt").write_text(
            "3\n0\n2 1 10.0 2 5.0\n1\n2 0 10.0 2 5.0\n2\n2 0 10.0 1 5.0\n")
        os.makedirs(root / "dtu_configs", exist_ok=True)
        (root / "dtu_configs" / "dtu_finetune_init_pairs.txt").write_text(
            "2\n0\n1,2\n1\n0,2\n")
    else:
        (cams / "pair.txt").write_text(
            "2\n0\n2 1 10.0 2 5.0\n1\n2 0 10.0 2 5.0\n")
    for v in range(3):
        ext = np.eye(4)
        ext[0, 3] = (200.0 if ft else 1.0) * v * 0.1
        txt = ("extrinsic\n"
               + "\n".join(" ".join(str(x) for x in row) for row in ext)
               + f"\n\nintrinsic\n{K}\n\n{depth_line}\n")
        (cams / "train" / f"{v:08d}_cam.txt").write_text(txt)
        _write_png(str(root / "Rectified" / "scan1_train"
                       / f"rect_{v + 1:03d}_3_r5000.png"),
                   (rng.rand(*size, 3) * 255).astype(np.uint8))


def _same_item(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("name", ["dtu", "dtu_ft"])
def test_dtu_items_match_jax(tmp_path, name):
    ft = name == "dtu_ft"
    dtu_fixture(tmp_path, ft, "425.0 2.5")
    kw = dict(n_depths=8) if ft else dict(nsrc=2, n_depths=8)

    def both(split):
        return [find(name)(cfgmod.DataConfig(
            dataset_name=name, data_root=str(tmp_path), scan="scan1"),
            split=split, **kw) for find, cfgmod in ((jfind, jcfg),
                                                    (tfind, tcfg))]
    for split in ("train", "test"):
        j, t = both(split)
        assert len(j) == len(t) == (1 if ft and split == "test" else 2)
        assert (j.width, j.height, j.near, j.far) == (t.width, t.height,
                                                      t.near, t.far)
        for i in range(len(j)):
            for rs in ("random", "no_crop") + (("patch",) if ft else ()):
                _same_item(j.get_item(i, random_sample=rs,
                                      random_sample_size=3, seed=i),
                           t.get_item(i, random_sample=rs,
                                      random_sample_size=3, seed=i))
            _same_item(j.get_mvs_item(i), t.get_mvs_item(i))
        if ft:
            _same_item(j.get_dummyrot_item(3), t.get_dummyrot_item(3))
    group = t.get_mvs_item(0)
    assert group["images"].shape == (3, 16, 20, 3)
    assert group["depth_values"].shape == (8,)


def _tiny_cfg(depth_lo, depth_hi):
    """tests/test_dataset_driver.py's DTU configuration, the eval at the
    last step, no jitter."""
    cfg = jcfg.scene_config(
        np.random.RandomState(0).normal(0, 1.0, (100, 3)).astype(np.float32),
        vox_res=16, K=4, SR=8, z_depth_dim=24, near=depth_lo, far=depth_hi)
    return cfg.replace(
        train=dataclasses.replace(cfg.train, random_sample_size=4,
                                  maximum_step=STEPS, prune_iter=0,
                                  prob_freq=0, test_freq=STEPS,
                                  save_iter_freq=STEPS, print_freq=1),
        query=dataclasses.replace(cfg.query, max_o=4096, P=8,
                                  knn_chunk=1024,
                                  ranges=(-8.0, -8.0, -8.0, 8.0, 8.0, 8.0),
                                  vsize=(0.5, 0.5, 0.5)),
        render=dataclasses.replace(cfg.render, train_jitter=0.0))


@pytest.fixture(scope="module")
def variables():
    return jax_mvs_variables(V=3, H=32, W=32, F=32)[1]


@pytest.mark.parametrize("name", ["dtu", "dtu_ft"])
def test_mvs_initialized_scene_matches_jax(tmp_path, monkeypatch, variables,
                                           name, capsys):
    """train_dataset_scene without a cloud on disk: mvs_init_cloud over
    the view groups (conf threshold 0 and one consistent view, as
    tests/test_dataset_driver.py runs it), then per-scene training; then
    the port's test_dataset_scene from its checkpoint."""
    ft = name == "dtu_ft"
    dtu_fixture(tmp_path, ft, "400.0 10.0" if ft else "2.0 0.05",
                size=(32, 32))
    cfg = _tiny_cfg(1.0, 6.0)
    pcfg = tcfg.PointNeRFConfig.from_json(cfg.to_json())
    _k1, k2, _k3 = jax.random.split(jax.random.PRNGKey(cfg.train.seed), 3)
    jparams = jax.tree.map(np.asarray, jd.init_mlp_params(k2, cfg))
    monkeypatch.setattr(td, "init_mlp_params", lambda _g, _c, device=None:
                        params_from_jax(jparams, device=device))
    kw = dict(depth_conf_thresh=0.0, geo_cnsst_num=1, point_features_dim=32)
    jkw = dict(kw, mvs_variables=variables)
    tkw = dict(kw, mvs_variables=mvs_variables_from_jax(variables,
                                                        device="cpu"))
    # the clouds alone
    jds = jfind(name)(jcfg.DataConfig(dataset_name=name,
                                      data_root=str(tmp_path), scan="scan1"),
                      split="train")
    tds = tfind(name)(tcfg.DataConfig(dataset_name=name,
                                      data_root=str(tmp_path), scan="scan1"),
                      split="train")
    jc = jd.mvs_init_cloud(jds, **jkw)
    tc = td.mvs_init_cloud(tds, device="cpu", **tkw)
    n = jc["xyz"].shape[0]
    assert n > 0 and tc["xyz"].shape[0] == n
    for k in ("xyz", "feature", "color", "normal", "conf"):
        scale = max(np.abs(jc[k]).max(), 1e-12)
        assert np.abs(tc[k] - jc[k]).max() / scale <= (
            POINT_TOL if k != "feature" else 2e-4), k
    # the whole driver
    js, jst, jh = jd.train_dataset_scene(
        name, str(tmp_path), "scan1", run_dir=str(tmp_path / "jrun"),
        max_steps=STEPS, cfg=cfg, resume=False, mvs_init_kwargs=jkw)
    ts, tst, th = td.train_dataset_scene(
        name, str(tmp_path), "scan1", run_dir=str(tmp_path / "trun"),
        max_steps=STEPS, cfg=pcfg, resume=False, mvs_init_kwargs=tkw,
        device="cpu")
    assert int(ts.step) == int(js.step) == STEPS
    assert int(tst.num_active) == int(jst.num_active) == n
    lj = [v for _s, v in jh["loss"]]
    lt = [v for _s, v in th["loss"]]
    assert len(lt) == len(lj) == STEPS
    np.testing.assert_allclose(lt, lj, rtol=CURVE_BAR)
    assert len(th["eval"]) == len(jh["eval"]) == 1
    assert abs(th["eval"][0]["psnr"] - jh["eval"][0]["psnr"]) < PSNR_BAR
    # the port's test pass rebuilds the cloud the same way and evaluates
    # the checkpoint on the same frames as the training run's eval
    m = td.test_dataset_scene(name, str(tmp_path), "scan1",
                              run_dir=str(tmp_path / "trun"), cfg=pcfg,
                              save_images=False, mvs_init_kwargs=tkw,
                              device="cpu")
    assert abs(m["psnr"] - th["eval"][0]["psnr"]) < 1e-6
    capsys.readouterr()


def test_ff_dataset_cli_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    """`--ff-dataset --device cpu` on tests/test_dataset_driver.py's
    feed-forward fixture: train_feedforward_dataset at a small config
    (the CLI sizes its own from the depth range; the test sizes it down)."""
    dtu_fixture(tmp_path, False, "2.0 0.05", size=(32, 32),
                K="25 0 16\n0 25 16\n0 0 1")
    small = td.ff_demo_config()
    small = small.replace(query=dataclasses.replace(
        small.query, vsize=(0.3, 0.3, 0.3), SR=8, z_depth_dim=24,
        ranges=(-6.0, -6.0, -6.0, 6.0, 6.0, 6.0), knn_chunk=1024),
        render=dataclasses.replace(small.render, far_plane=3.2))
    monkeypatch.setattr(td, "scene_config", lambda *a, **k: small)
    monkeypatch.setattr(sys, "argv", [
        "driver", "--ff-dataset", "--data-root", str(tmp_path), "--scan",
        "scan1", "--run-dir", str(tmp_path / "ff"), "--steps", "2",
        "--device", "cpu"])
    td.main()
    state, infer = td.train_feedforward_dataset(
        str(tmp_path), "scan1", run_dir=str(tmp_path / "ff2"), max_steps=2,
        cfg=small, n_depths=24, n_rays=36, log_every=1, device="cpu")
    assert int(state.step) == 2
    assert all(torch.isfinite(v).all() for v in state.params["mvs"].values())
    out = capsys.readouterr().out
    assert "[feedforward] step 2" in out
