"""The port's eval render end to end (pointnerf_tpu_torch/train/step.eval_step)
against the JAX eval_step, with the same weights (convert.params_from_jax),
the same cloud (convert.point_cloud_from_numpy) and the same rays.

Config: tiny_test_config with prebuild_neighbors=True, shell_layered=False,
decode_capacity=0.5, knn_select="pallas", fused_decode=True and
fused_march=True, f32 (the JAX Pallas kernels run in interpret mode; the
port's kernels run their plain versions on CPU tensors). Integers —
sample_mask (ray_valid), neighbor_pidx, ray_mask, decode_dropped — must be
equal; colors, depth and opacity within the 2e-4 decode bar."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.camera import get_dtu_raydir
from pointnerf_tpu.config import tiny_test_config
from pointnerf_tpu.models.aggregator import init_aggregator_params
from pointnerf_tpu.models.points import make_point_cloud
from pointnerf_tpu.models.renderer import RayBatch
from pointnerf_tpu.train.step import eval_step, refresh_grid
from pointnerf_tpu_torch import config as tc
from pointnerf_tpu_torch.convert import params_from_jax, point_cloud_from_numpy
from pointnerf_tpu_torch.models import aggregator as ta
from pointnerf_tpu_torch.models import renderer as tr
from pointnerf_tpu_torch.ops.fused_decode import route
from pointnerf_tpu_torch.train import step as ts

TOL = 2e-4
INTS = ("ray_valid", "ray_mask", "decode_dropped", "neighbor_pidx")
FLOATS = ("coarse_raycolor", "coarse_depth", "coarse_point_opacity",
          "coarse_is_background", "queried_shading", "weight",
          "conf_coefficient", "sample_loc_w")


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Every Pallas kernel in interpret mode (the march passes no flag; the
    KNN and decode kernels pass their own, which this overrides)."""
    import jax.experimental.pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _cfg(fused=True, capacity=0.5):
    cfg = tiny_test_config()
    return cfg.replace(
        query=dataclasses.replace(cfg.query, prebuild_neighbors=True,
                                  shell_layered=False,
                                  decode_capacity=capacity,
                                  knn_select="pallas"),
        agg=dataclasses.replace(cfg.agg, fused_decode=fused),
        render=dataclasses.replace(cfg.render, fused_march=fused))


# fixtures copied from tests/test_render.py
def synthetic_scene(seed=0, n_pts=400):
    rng = np.random.RandomState(seed)
    xyz = rng.normal(0, 0.25, (n_pts, 3)).astype(np.float32)
    xyz = np.clip(xyz, -0.9, 0.9)
    campos = np.array([0.0, 0.0, -3.0], np.float32)
    camrot = np.eye(3, dtype=np.float32)
    return xyz, campos, camrot


def make_batch(campos, camrot, R=64, seed=1, near=2.0, far=4.5):
    rng = np.random.RandomState(seed)
    intr = np.array([[80.0, 0, 32.0], [0, 80.0, 32.0], [0, 0, 1]], np.float32)
    pix = rng.randint(0, 64, (R, 2)).astype(np.float32)
    raydir = get_dtu_raydir(pix, intr, camrot, True).astype(np.float32)
    return {"campos": campos, "camrotc2w": camrot, "raydir": raydir,
            "pixel_idx": pix.astype(np.int32)}


def setup(cfg, seed=0):
    xyz, campos, camrot = synthetic_scene(seed)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    pc, st = make_point_cloud(xyz, k1, cfg.points, cfg.agg.point_features_dim,
                              capacity=512)
    params = init_aggregator_params(k2, cfg.agg)
    grid = refresh_grid(pc, st, cfg)
    return pc, st, params, grid, campos, camrot


def _render_both(cfg, R=64, seed=0, batch_seed=1):
    pc, st, params, grid, campos, camrot = setup(cfg, seed)
    item = make_batch(campos, camrot, R=R, seed=batch_seed)
    jb = RayBatch(campos=jnp.asarray(campos), camrotc2w=jnp.asarray(camrot),
                  raydir=jnp.asarray(item["raydir"]),
                  pixel_idx=jnp.asarray(item["pixel_idx"]),
                  near=jnp.asarray(2.0), far=jnp.asarray(4.5))
    oj = eval_step({"mlp": params, "points": pc}, st, grid, jb, cfg)
    tcfg = tc.PointNeRFConfig.from_json(cfg.to_json())
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    tpc, tst = point_cloud_from_numpy(*[np.asarray(a) for a in pc],
                                      num_active=int(st.num_active),
                                      device="cpu")
    tgrid, _ = ts.refresh_grid(tpc, tst, tcfg)
    tb = tr.ray_batch_from_numpy(item, tcfg, device="cpu")
    ot = ts.eval_step({"mlp": tp, "points": tpc}, tst, tgrid, tb, tcfg)
    return oj, ot


def _assert_parity(oj, ot):
    for f in INTS:
        a, b = np.asarray(getattr(oj, f)), getattr(ot, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    for f in FLOATS:
        a, b = np.asarray(getattr(oj, f)), getattr(ot, f).numpy()
        assert a.shape == b.shape, f
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, err_msg=f)


@pytest.mark.parametrize("seed,batch_seed", [(0, 1), (1, 2)])
def test_eval_step_matches_jax(interpret_pallas, seed, batch_seed):
    oj, ot = _render_both(_cfg(), seed=seed, batch_seed=batch_seed)
    _assert_parity(oj, ot)
    assert ot.ray_mask.any() and not ot.ray_mask.all()
    assert int(ot.decode_dropped) == 0


def test_eval_step_plain_branches_match_jax():
    """fused_decode=False, fused_march=False: the plain aggregate branch and
    the plain march (CPU only — on CUDA the port requires the kernels)."""
    oj, ot = _render_both(_cfg(fused=False))
    _assert_parity(oj, ot)


def test_eval_step_overflow_counts_dropped(interpret_pallas):
    """More valid slots than the compact capacity: the overflow renders as
    background and decode_dropped counts it, equal in both packages."""
    oj, ot = _render_both(_cfg(capacity=0.25), R=128)
    _assert_parity(oj, ot)
    assert int(ot.decode_dropped) > 0


def test_out_of_slice_configs_raise():
    cfg = tc.PointNeRFConfig.from_json(_cfg().to_json())
    dev = torch.device("cpu")
    # the dense decode is in the envelope, on the card too
    dense = cfg.replace(query=dataclasses.replace(cfg.query,
                                                  decode_capacity=0.0))
    tr.check_envelope(dense, dev)
    tr.check_envelope(dense, torch.device("cuda"))
    tr.check_envelope(dense, torch.device("cuda"), train=True)
    # the fine pass and the hybrid run on the kernels of the coarse pass:
    # accepted on both devices, serving and training
    for ext in (dict(fine_sample_num=4), dict(nerf_importance=4),
                dict(fine_sample_num=4, nerf_importance=4)):
        c = cfg.replace(render=dataclasses.replace(cfg.render, **ext))
        for d in (dev, torch.device("cuda")):
            tr.check_envelope(c, d)
            tr.check_envelope(c, d, train=True)
    # training is accepted: on the CPU in both formulations, on the card
    # with the fused decode (the march is the plain one in training, as in
    # JAX, so fused_march may be off there)
    plain = tc.PointNeRFConfig.from_json(_cfg(fused=False).to_json())
    tr.check_envelope(cfg, dev, train=True)
    tr.check_envelope(plain, dev, train=True)
    tr.check_envelope(cfg, torch.device("cuda"), train=True)
    tr.check_envelope(cfg.replace(render=dataclasses.replace(
        cfg.render, fused_march=False)), torch.device("cuda"), train=True)
    # on the card the kernels run inside the fused envelope whatever the
    # flags say, so the flags-off config is accepted there too
    tr.check_envelope(plain, torch.device("cuda"))
    tr.check_envelope(plain, torch.device("cuda"), train=True)
    # past the tuned kernels' limits the card takes the general K3 and K4,
    # whatever the flag: inside the envelope the card never runs the
    # kernel's plain twin, and no spec is refused
    tr.check_envelope(cfg, torch.device("cuda"))
    wide = cfg.replace(agg=dataclasses.replace(cfg.agg,
                                               shading_feature_num=512))
    tr.check_envelope(wide, torch.device("cuda"))
    tr.check_envelope(wide.replace(agg=dataclasses.replace(
        wide.agg, fused_decode=False)), torch.device("cuda"), train=True)
    # eight 256-wide layers train on both tuned routes; a first layer 620
    # wide (point_features_dim 80) fits K3 f32 but not K4 f32, so in f32
    # the card serves it on the tuned K3 and trains it on the general K4
    deep = tc.bench_config()
    deep = deep.replace(
        agg=dataclasses.replace(deep.agg, fused_decode=True,
                                shading_feature_mlp_layer1=4,
                                shading_feature_mlp_layer3=4),
        render=dataclasses.replace(deep.render, fused_march=True))
    deep32 = deep.replace(train=dataclasses.replace(deep.train,
                                                    compute_dtype="f32"))
    tr.check_envelope(deep32, torch.device("cuda"))
    tr.check_envelope(deep32, torch.device("cuda"), train=True)
    tr.check_envelope(deep, torch.device("cuda"), train=True)
    wide32 = deep32.replace(agg=dataclasses.replace(
        deep32.agg, point_features_dim=80, shading_feature_mlp_layer1=2,
        shading_feature_mlp_layer3=2))
    tr.check_envelope(wide32, torch.device("cuda"))
    tr.check_envelope(wide32, torch.device("cuda"), train=True)
    spec = ta.decode_spec(wide32.agg, wide32.query.K, bf16=False)
    assert route(spec) == "cuda_core"
    assert route(spec, backward=True) == "general"


def test_camera_and_gather_match_jax():
    from pointnerf_tpu.camera import pers2w as j_pers2w, w2pers as j_w2pers
    from pointnerf_tpu.models.points import gather_points as j_gather
    from pointnerf_tpu_torch.camera import pers2w, w2pers
    from pointnerf_tpu_torch.models.points import gather_points
    rng = np.random.RandomState(0)
    xyz = rng.randn(50, 3).astype(np.float32)
    xyz[:, 2] += 5.0
    q = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
    campos = np.array([0.2, -0.3, -2.0], np.float32)
    pj = j_w2pers(jnp.asarray(xyz), jnp.asarray(q), jnp.asarray(campos))
    pt = w2pers(torch.from_numpy(xyz), torch.from_numpy(q),
                torch.from_numpy(campos))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5,
                               atol=1e-6)
    back = pers2w(pt, torch.from_numpy(q), torch.from_numpy(campos))
    np.testing.assert_allclose(back.numpy(), xyz, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(j_pers2w(pj, jnp.asarray(q),
                                          jnp.asarray(campos))),
        rtol=1e-5, atol=1e-5)
    cfg = tiny_test_config()
    pc, st = make_point_cloud(xyz, jax.random.PRNGKey(1), cfg.points, 8,
                              capacity=64)
    tpc, _ = point_cloud_from_numpy(*[np.asarray(a) for a in pc],
                                    num_active=50, device="cpu")
    pidx = rng.randint(-1, 50, size=(7, 3, 4)).astype(np.int32)
    pers = rng.randn(64, 3).astype(np.float32)
    sj = j_gather(pc, jnp.asarray(pers), jnp.asarray(pidx))
    stt = gather_points(tpc, torch.from_numpy(pers), torch.from_numpy(pidx))
    for f in sj._fields:
        np.testing.assert_array_equal(getattr(stt, f).numpy(),
                                      np.asarray(getattr(sj, f)), err_msg=f)


def test_synthetic_scene_matches_jax():
    from pointnerf_tpu.data import synthetic as js
    from pointnerf_tpu_torch.data import synthetic as ts_
    for a, b in zip(js.sphere_scene(500, seed=3), ts_.sphere_scene(500,
                                                                    seed=3)):
        np.testing.assert_array_equal(a, b)
    cj = js.ring_cameras(n_views=3, wh=(64, 64))
    ct = ts_.ring_cameras(n_views=3, wh=(64, 64))
    for vj, vt in zip(cj, ct):
        for a, b in zip(vj, vt):
            np.testing.assert_array_equal(a, b)
    ij = js.view_ray_batch(*cj[1], (64, 64), n_rays=100, seed=4)
    it = ts_.view_ray_batch(*ct[1], (64, 64), n_rays=100, seed=4)
    for k in ("raydir", "pixel_idx", "gt_image"):
        np.testing.assert_array_equal(ij[k], it[k])
