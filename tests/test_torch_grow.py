"""The port's point maintenance (pointnerf_tpu_torch/train/grow.py) against
the JAX package's train/grow.py, on the same scene, weights and training
state (convert.train_state_from_jax of a JAX state after two steps).

- probe_hole: the candidates equal in count and within 2e-4 in value (the
  decode bar), after asserting that no ray's argmax or threshold test sits
  within the 1e-5 march bar of flipping;
- apply_prune / apply_grow: cloud, Adam moments and hit counters equal
  (they move values without arithmetic), with and without a re-bucket;
- split_high_grad: the same parents and offspring, bit for bit (both draw
  from np.random.RandomState(step) on the same counters).

Config: tiny_test_config (tests/test_torch_render.py) in f32, JAX Pallas
kernels in interpret mode, the port's plain versions on CPU tensors."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.camera import get_dtu_raydir
from pointnerf_tpu.train import grow as jg
from pointnerf_tpu.train.step import eval_step
from pointnerf_tpu_torch.convert import train_state_from_jax
from pointnerf_tpu_torch.train import grow as tg
from test_torch_dense import MARCH_BAR, TOL, assert_argmax_margin
from test_torch_render import interpret_pallas  # noqa: F401
from test_torch_train import _port_st, _scene, _train_cfg, _warm_jax_state

WH = (32, 32)
PROB_THRESH = 0.02


def _frame(campos, camrot, seed=0):
    """A full 32 x 32 frame (the intrinsics of make_batch halved) with a
    black ground truth, so every ray that misses the cloud is a hole."""
    W, H = WH
    intr = np.array([[40.0, 0, 16.0], [0, 40.0, 16.0], [0, 0, 1]], np.float32)
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    pix = np.stack([u.ravel(), v.ravel()], -1).astype(np.float32)
    raydir = get_dtu_raydir(pix, intr, camrot, True).astype(np.float32)
    return {"campos": campos, "camrotc2w": camrot, "raydir": raydir,
            "pixel_idx": pix.astype(np.int32),
            "gt_image": np.zeros((W * H, 3), np.float32), "id": seed}


@pytest.fixture(scope="module")
def base():
    """One JAX training state after two steps (hits tracked, colors and dirs
    on the cloud, the alpha bias raised so the peak opacities straddle
    PROB_THRESH) and its port copy, shared by the tests of this file."""
    with pytest.MonkeyPatch.context() as mp:
        import jax.experimental.pallas as pl
        orig = pl.pallas_call
        mp.setattr(pl, "pallas_call",
                   lambda *a, **k: orig(*a, **{**k, "interpret": True}))
        cfg = _train_cfg(track_hits=True, jitter=0.0)
        pc, st, params, grid, jb, _tcfg, _tb, _tgrid = _scene(cfg)
        params = jax.tree.map(lambda x: x, params)
        params["alpha"][0]["b"] = params["alpha"][0]["b"] + 3.0
        rng = np.random.RandomState(5)
        pc = pc._replace(
            color=jnp.asarray(rng.rand(pc.capacity, 3), jnp.float32),
            dirs=jnp.asarray(rng.randn(pc.capacity, 3), jnp.float32))
        state_np = _warm_jax_state(cfg, params, pc, grid, st, jb)
    return cfg, state_np, st, jb


def _states(base, prob_thresh=PROB_THRESH, **train):
    from pointnerf_tpu_torch import config as tc
    cfg, state_np, st, jb = base
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, prob_thresh=prob_thresh, **train))
    jstate = jax.tree.map(jnp.asarray, state_np)
    tstate = train_state_from_jax(state_np, torch.Generator(), device="cpu")
    tcfg = tc.PointNeRFConfig.from_json(cfg.to_json())
    return cfg, tcfg, jstate, st, tstate, _port_st(st), jb


def _grid_pair(cfg, tcfg, jstate, st, tstate, tst):
    from pointnerf_tpu.train.step import refresh_grid as j_refresh
    from pointnerf_tpu_torch.train.step import refresh_grid
    return (j_refresh(jstate.params["points"], st, cfg),
            refresh_grid(tstate.params["points"], tst, tcfg)[0])


def _assert_state_equal(tstate, jstate, tst, jst):
    assert int(tst.num_active) == int(jst.num_active)
    for f in jstate.params["points"]._fields:
        np.testing.assert_array_equal(
            getattr(tstate.params["points"], f).numpy(),
            np.asarray(getattr(jstate.params["points"], f)), err_msg=f)
    inner = jstate.opt_state.inner_states["points"].inner_state[0]
    for m in ("mu", "nu"):
        jm, tm = getattr(inner, m)["points"], getattr(
            tstate.opt_state["points"], m)
        for f in jm._fields:
            np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                          np.asarray(getattr(jm, f)),
                                          err_msg=f"{m}.{f}")
    np.testing.assert_array_equal(tstate.hits.numpy(),
                                  np.asarray(jstate.hits))


def test_probe_hole_matches_jax(interpret_pallas, base):
    cfg, tcfg, jstate, st, tstate, tst, jb = _states(base)
    jgrid, tgrid = _grid_pair(cfg, tcfg, jstate, st, tstate, tst)
    item = _frame(np.asarray(jb.campos), np.asarray(jb.camrotc2w))
    # the margins the comparison needs, on JAX's own render of the frame
    from pointnerf_tpu.models.renderer import RayBatch
    rays = RayBatch(campos=jb.campos, camrotc2w=jb.camrotc2w,
                    raydir=jnp.asarray(item["raydir"]),
                    pixel_idx=jnp.asarray(item["pixel_idx"]), near=jb.near,
                    far=jb.far)
    o = eval_step(jstate.params, st, jgrid, rays, cfg, prob=True)
    # the rays whose probe outputs the candidates read: hit rays next to a
    # miss (the ground truth is all black, so every miss is a hole)
    hit = np.asarray(o.ray_mask).reshape(WH[1], WH[0])
    near_hole = (hit & jg._dilate3(~hit)).reshape(-1)
    assert_argmax_margin(np.asarray(o.coarse_point_opacity)[near_hole])
    max_op = np.asarray(o.ray_max_shading_opacity)[near_hole, 0]
    assert np.abs(max_op - PROB_THRESH).min() > MARCH_BAR
    assert (max_op > PROB_THRESH).any() and (max_op < PROB_THRESH).any()

    cj = jg.probe_hole(jstate.params, st, jgrid, cfg, [item], WH, chunk=1024)
    # the port in chunks of 400 rays (the last one padded)
    ct = tg.probe_hole(tstate.params, tst, tgrid, tcfg, [item], WH, chunk=400)
    assert cj.xyz.shape[0] > 0
    for f in cj._fields:
        a, b = getattr(ct, f), getattr(cj, f)
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=f)


def test_render_full_frame_eval_maps_match_jax(interpret_pallas, base):
    """The eval maps (compacted decode, prob=False) of a full frame."""
    cfg, tcfg, jstate, st, tstate, tst, jb = _states(base)
    jgrid, tgrid = _grid_pair(cfg, tcfg, jstate, st, tstate, tst)
    item = _frame(np.asarray(jb.campos), np.asarray(jb.camrotc2w))
    mj = jg.render_full_frame(jstate.params, st, jgrid, cfg, item, WH,
                              chunk=1024, prob=False)
    mt = tg.render_full_frame(tstate.params, tst, tgrid, tcfg, item, WH,
                              chunk=1024, prob=False)
    assert sorted(mt) == sorted(mj)
    np.testing.assert_array_equal(mt["ray_mask"], mj["ray_mask"])
    np.testing.assert_allclose(mt["coarse_raycolor"], mj["coarse_raycolor"],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("min_hits", [0.0, 3.0])
def test_apply_prune_matches_jax(base, min_hits):
    cfg, tcfg, jstate, st, tstate, tst, _jb = _states(
        base, prune_thresh=0.15, prune_min_hits=min_hits)
    # a known subset below the threshold
    conf = np.asarray(jstate.params["points"].conf).copy()
    conf[::3] = 0.05
    jpc = jstate.params["points"]._replace(conf=jnp.asarray(conf))
    jstate = jstate._replace(params=dict(jstate.params, points=jpc))
    tstate = tstate._replace(params=dict(
        tstate.params, points=tstate.params["points"]._replace(
            conf=torch.from_numpy(conf))))
    js2, jst2, jkept = jg.apply_prune(jstate, st, cfg)
    ts2, tst2, tkept = tg.apply_prune(tstate, tst, tcfg)
    assert tkept == jkept < int(st.num_active)
    _assert_state_equal(ts2, js2, tst2, jst2)


@pytest.mark.parametrize("n_new", [40, 3800])
def test_apply_grow_matches_jax(base, n_new):
    """40 candidates fit the 512 bucket; 3800 move it to 4096 (moments,
    hits and the cloud padded)."""
    cfg, tcfg, jstate, st, tstate, tst, _jb = _states(base)
    rng = np.random.RandomState(n_new)
    F = cfg.agg.point_features_dim
    cand = jg.ProbeCandidates(
        xyz=rng.uniform(-0.5, 0.5, (n_new, 3)).astype(np.float32),
        embedding=rng.rand(n_new, F).astype(np.float32),
        color=rng.rand(n_new, 3).astype(np.float32),
        dirs=rng.randn(n_new, 3).astype(np.float32),
        conf=rng.rand(n_new, 1).astype(np.float32))
    js2, jst2, jadded = jg.apply_grow(jstate, st, cand, cfg)
    ts2, tst2, tadded = tg.apply_grow(tstate, tst, tg.ProbeCandidates(*cand),
                                      tcfg)
    assert tadded == jadded == n_new
    assert ts2.params["points"].capacity == js2.params["points"].capacity
    _assert_state_equal(ts2, js2, tst2, jst2)


def test_split_high_grad_matches_jax(base):
    cfg, tcfg, jstate, st, tstate, tst, _jb = _states(base, split_top=16,
                                                      split_iter=5)
    assert float(np.asarray(jstate.hits)[:, 2].max()) > 0
    js2, jst2, jadded = jg.split_high_grad(jstate, st, cfg)
    ts2, tst2, tadded = tg.split_high_grad(tstate, tst, tcfg)
    assert tadded == jadded == 16
    _assert_state_equal(ts2, js2, tst2, jst2)


def test_nerf_create_points_is_not_ported():
    """NeRF-driven creation is ported now (tests/test_torch_hybrid*.py):
    probe_hole takes nerf_create_points and, over no probe frame, returns
    no candidate."""
    from pointnerf_tpu_torch import config as tc
    cfg = tc.tiny_test_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                nerf_create_points=True))
    cand = tg.probe_hole(None, None, None, cfg, [], WH)
    assert cand.xyz.shape == (0, 3)
    assert cand.embedding.shape == (0, cfg.agg.point_features_dim)


def test_dilate3_matches_jax():
    m = np.random.RandomState(0).rand(9, 11) < 0.1
    np.testing.assert_array_equal(tg._dilate3(m), jg._dilate3(m))
