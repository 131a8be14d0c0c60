"""Reference checkpoints in and out of the port
(pointnerf_tpu_torch/train/torch_import.py) against the JAX package's
importer, and the orbax-to-port converter (scripts/orbax_to_port.py).

A synthetic reference `net_ray_marching` state dict (torch tensors from a
numpy seed, the DataParallel "module." prefix, Linear pairs at even
Sequential indices) at tiny_test_config's widths, with a global Rw2c or a
per-point one:
- the port's import equals JAX's array for array, and a request rendered
  from each agrees at the serving bars (integers equal, colors 1e-5;
  JAX's Pallas kernels in interpret mode, the port's plain versions);
- the export round trip, the .pth path and the .npz path give the same
  scene, and an architecture mismatch raises a ValueError naming both
  shapes;
- a JAX checkpoint written by save_checkpoint (every Adam moment, count
  and hit counter filled from a seed), converted by the script, restores
  in the port as convert.train_state_from_jax of the same state with a
  generator seeded from cfg.train.seed + 2 (as the drivers seed theirs)
  does, and one train step from each gives the same bits.
No file outside the repository is read."""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.config import tiny_test_config
from pointnerf_tpu.models.aggregator import init_aggregator_params
from pointnerf_tpu.models.renderer import RayBatch
from pointnerf_tpu.train import step as js
from pointnerf_tpu.train import torch_import as jti
from pointnerf_tpu_torch import config as tc
from pointnerf_tpu_torch.models import renderer as tr
from pointnerf_tpu_torch.train import step as ts
from pointnerf_tpu_torch.train import torch_import as tti
from test_torch_render import _cfg, make_batch, synthetic_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLOR_TOL = 1e-5
INTS = ("ray_valid", "ray_mask", "decode_dropped", "neighbor_pidx")
BLOCKS = (("block1", "aggregator.block1"), ("block3", "aggregator.block3"),
          ("alpha", "aggregator.alpha_branch"),
          ("color", "aggregator.color_branch"))


def reference_state_dict(cfg, per_point: bool, seed: int = 0, n: int = 300):
    """A reference-format scene checkpoint of `n` points at cfg's widths."""
    rng = np.random.RandomState(seed)
    xyz, _, _ = synthetic_scene(n_pts=n)
    F = cfg.agg.point_features_dim

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))
    sd = {"neural_points.xyz": t(xyz),
          "neural_points.points_embeding": t(rng.rand(1, n, F) * 0.5),
          "neural_points.points_conf": t(rng.rand(1, n, 1)),
          "neural_points.points_dir": t(rng.normal(size=(1, n, 3))),
          "neural_points.points_color": t(rng.rand(1, n, 3))}
    if per_point:
        q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
        sd["neural_points.Rw2c"] = t(q)
    else:
        sd["neural_points.Rw2c"] = t(np.eye(3))
    shapes = jax.tree.map(lambda a: a.shape, init_aggregator_params(
        jax.random.PRNGKey(0), cfg.agg))
    for ours, prefix in BLOCKS:
        for i, layer in enumerate(shapes[ours]):
            d_in, d_out = layer["w"]
            sd[f"{prefix}.{2 * i}.weight"] = t(
                rng.normal(size=(d_out, d_in)) / np.sqrt(d_in))
            sd[f"{prefix}.{2 * i}.bias"] = t(0.05 * rng.normal(size=d_out))
    return {"module." + k: v for k, v in sd.items()}


def _assert_scene_equal(t_scene, j_scene):
    tpc, tst, tparams = t_scene
    jpc, jst, jparams = j_scene
    for f in jpc._fields:
        np.testing.assert_array_equal(getattr(tpc, f).numpy(),
                                      np.asarray(getattr(jpc, f)), err_msg=f)
    assert int(tst.num_active) == int(jst.num_active)
    np.testing.assert_array_equal(tst.Rw2c.numpy(), np.asarray(jst.Rw2c))
    assert set(tparams) == set(jparams)
    for k, layers in jparams.items():
        assert len(tparams[k]) == len(layers)
        for tl, jl in zip(tparams[k], layers):
            for n in ("w", "b"):
                np.testing.assert_array_equal(tl[n].numpy(),
                                              np.asarray(jl[n]))


@pytest.fixture(scope="module")
def imported():
    """Both packages' imports of the global and the per-point checkpoint
    and a request rendered from each, JAX's kernels in interpret mode."""
    import jax.experimental.pallas as pl
    mp = pytest.MonkeyPatch()
    orig = pl.pallas_call
    mp.setattr(pl, "pallas_call",
               lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    cfg = _cfg()
    tcfg = tc.PointNeRFConfig.from_json(cfg.to_json())
    _x, campos, camrot = synthetic_scene(n_pts=300)
    item = make_batch(campos, camrot, R=96, seed=3)
    jb = RayBatch(campos=jnp.asarray(campos), camrotc2w=jnp.asarray(camrot),
                  raydir=jnp.asarray(item["raydir"]),
                  pixel_idx=jnp.asarray(item["pixel_idx"]),
                  near=jnp.asarray(2.0), far=jnp.asarray(4.5))
    tb = tr.ray_batch_from_numpy(item, tcfg, device="cpu")
    out = {}
    try:
        for per_point in (False, True):
            sd = reference_state_dict(cfg, per_point)
            j_scene = jti.import_reference_scene(sd, cfg)
            t_scene = tti.import_reference_scene(sd, tcfg, device="cpu")
            jpc, jst, jp = j_scene
            tpc, tst, tp = t_scene
            oj = js.eval_step({"mlp": jp, "points": jpc}, jst,
                              js.refresh_grid(jpc, jst, cfg), jb, cfg)
            ot = ts.eval_step({"mlp": tp, "points": tpc}, tst,
                              ts.refresh_grid(tpc, tst, tcfg)[0], tb, tcfg)
            out[per_point] = (sd, j_scene, t_scene, oj, ot)
    finally:
        mp.undo()
    return cfg, tcfg, out


@pytest.mark.parametrize("per_point", [False, True])
def test_import_matches_jax(imported, per_point):
    _cfg_, _t, out = imported
    _sd, j_scene, t_scene, _oj, _ot = out[per_point]
    _assert_scene_equal(t_scene, j_scene)
    assert t_scene[1].Rw2c.dim() == (3 if per_point else 2)


@pytest.mark.parametrize("per_point", [False, True])
def test_imported_scene_renders_as_jax(imported, per_point):
    _c, _t, out = imported
    *_, oj, ot = out[per_point]
    for f in INTS:
        np.testing.assert_array_equal(getattr(ot, f).numpy(),
                                      np.asarray(getattr(oj, f)), err_msg=f)
    hit = np.asarray(oj.ray_mask)
    assert hit.sum() > 10
    np.testing.assert_allclose(ot.coarse_raycolor.numpy()[hit],
                               np.asarray(oj.coarse_raycolor)[hit],
                               rtol=0, atol=COLOR_TOL)


@pytest.mark.parametrize("per_point", [False, True])
def test_export_round_trip(imported, tmp_path, per_point):
    """export(import(sd)) holds sd's values under sd's keys (without the
    prefix); it imports, from a dict, a .pth and an .npz, to the same
    scene; for a global Rw2c it equals JAX's export."""
    cfg, tcfg, out = imported
    sd, j_scene, t_scene, _oj, _ot = out[per_point]
    exp = tti.export_reference_scene(*t_scene)
    assert set(exp) == {k[len("module."):] for k in sd}
    for k, v in exp.items():
        assert torch.equal(v, sd["module." + k]), k
    if not per_point:
        jexp = jti.export_reference_scene(*j_scene)
        for k, v in jexp.items():
            np.testing.assert_array_equal(exp[k].numpy(), v, err_msg=k)
    pth, npz = str(tmp_path / "net_ray_marching.pth"), str(tmp_path / "s.npz")
    torch.save(sd, pth)
    tti.torch_dict_to_npz(pth, npz)
    for src in (exp, pth, tti.load_npz_checkpoint(npz)):
        again = tti.import_reference_scene(src, tcfg, device="cpu")
        for a, b in zip(again[0], t_scene[0]):
            assert torch.equal(a, b)
        assert torch.equal(again[1].Rw2c, t_scene[1].Rw2c)
        assert int(again[1].num_active) == int(t_scene[1].num_active)


def test_import_rejects_an_architecture_mismatch(imported):
    cfg, tcfg, out = imported
    sd = out[False][0]
    wide = tcfg.replace(agg=dataclasses.replace(tcfg.agg,
                                                shading_feature_num=64))
    with pytest.raises(ValueError, match="architecture mismatch") as e:
        tti.import_reference_scene(sd, wide, device="cpu")
    msg = str(e.value)
    assert "checkpoint:" in msg and "config:" in msg
    # the config's block1 output width (64) and the checkpoint's, both named
    h = tcfg.agg.shading_feature_num
    assert f", {h})" in msg.split("config:")[0] and ", 64)" in msg
    narrow = tcfg.replace(agg=dataclasses.replace(tcfg.agg,
                                                  point_features_dim=4))
    with pytest.raises(ValueError, match="feature dim"):
        tti.import_reference_scene(sd, narrow, device="cpu")


def _converter():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_port", os.path.join(REPO, "scripts", "orbax_to_port.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_orbax_checkpoint_converts_and_trains(tmp_path):
    from pointnerf_tpu.models.points import make_point_cloud as j_cloud
    from pointnerf_tpu.train.checkpoint import save_checkpoint as j_save
    from pointnerf_tpu_torch.convert import train_state_from_jax
    from pointnerf_tpu_torch.models.points import make_point_cloud
    from pointnerf_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                      load_checkpoint)
    from test_torch_train import _port_st
    cfg = tiny_test_config()
    tcfg = tc.PointNeRFConfig.from_json(cfg.to_json())
    xyz, campos, camrot = synthetic_scene(n_pts=300)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    pc, st = j_cloud(xyz, k1, cfg.points, cfg.agg.point_features_dim,
                     capacity=512)
    item = make_batch(campos, camrot, R=64, seed=1)
    item["gt_image"] = np.random.RandomState(2).rand(64, 3).astype(
        np.float32)
    state = js.create_train_state(jax.random.PRNGKey(7),
                                  init_aggregator_params(k2, cfg.agg), pc, cfg)
    # a state in mid-training without a compiled step: every Adam moment,
    # count and hit counter filled from a seed, each leaf its own values
    rng = np.random.RandomState(4)

    def fill(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            return jnp.asarray(rng.rand(*x.shape).astype(x.dtype))
        return jnp.asarray(np.full(x.shape, 3, x.dtype))
    state = state._replace(opt_state=jax.tree.map(fill, state.opt_state),
                           step=jnp.asarray(3, jnp.int32),
                           hits=fill(state.hits))
    run = tmp_path / "jax_run"
    os.makedirs(run)
    (run / "opt.json").write_text(cfg.to_json())
    ckpt = j_save(str(run), state, {"num_active": int(st.num_active),
                                    "capacity": 512})
    port_ckpt = _converter().convert_checkpoint(ckpt, str(tmp_path / "port"),
                                                device="cpu")
    assert latest_checkpoint(str(tmp_path / "port")) == port_ckpt
    assert tc.PointNeRFConfig.from_json(
        (tmp_path / "port" / "opt.json").read_text()) == tcfg

    ref = train_state_from_jax(
        jax.tree.map(np.asarray, state),
        torch.Generator().manual_seed(tcfg.train.seed + 2), device="cpu")
    tpc, _ = make_point_cloud(np.zeros((512, 3), np.float32),
                              torch.Generator().manual_seed(0), tcfg.points,
                              tcfg.agg.point_features_dim, capacity=512,
                              device="cpu")
    from pointnerf_tpu_torch.models.aggregator import \
        init_aggregator_params as t_init
    template = ts.create_train_state(
        torch.Generator().manual_seed(5),
        t_init(tcfg.agg, torch.Generator().manual_seed(1), device="cpu"),
        tpc, tcfg)
    got, meta = load_checkpoint(port_ckpt, template)
    assert meta["num_active"] == int(st.num_active) and int(got.step) == 3
    leaves = jax.tree.leaves
    for a, b in zip(leaves(got[:3], is_leaf=torch.is_tensor),
                    leaves(ref[:3], is_leaf=torch.is_tensor)):
        assert torch.equal(a, b)
    assert torch.equal(got.hits, ref.hits)
    assert torch.equal(got.key.get_state(), ref.key.get_state())
    tst = _port_st(st)
    tgrid, _ = ts.refresh_grid(got.params["points"], tst, tcfg)
    tb = tr.ray_batch_from_numpy(item, tcfg, device="cpu")
    u = torch.rand((64, tcfg.query.z_depth_dim),
                   generator=torch.Generator().manual_seed(3))
    a, _ = ts.train_step(got, tst, tgrid, tb, tcfg, u=u)
    b, _ = ts.train_step(ref, tst, tgrid, tb, tcfg, u=u)
    for x, y in zip(leaves(a[:3], is_leaf=torch.is_tensor),
                    leaves(b[:3], is_leaf=torch.is_tensor)):
        assert torch.equal(x, y)
