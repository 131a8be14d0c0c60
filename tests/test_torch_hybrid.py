"""The fine pass and the proposal-NeRF hybrid of the port
(pointnerf_tpu_torch/ops/query.sample_pdf / refine_ray_generation,
models/nerf_branch, models/renderer._fine_pass / _hybrid_march) against the
JAX package's, with the same weights (convert.params_from_jax), cloud and
rays, and JAX's own random draws injected.

Config: the tiny_test_config of tests/test_torch_render.py (prebuilt
tables, decode_capacity 0.5, K1, the fused flags), f32, with a small field
(hidden 32, 2 layers, PE 4 / 2); JAX's Pallas kernels in interpret mode.
Bars: bin indices, neighbor ids, masks and the merge order equal; samples
within 1e-6 relative; the field's outputs, the fine color, the losses,
gradients and Adam moments within 2e-4 (the decode bar); the merged color
within 1e-5 (the march bar). The bin-index comparisons first assert that no
draw u lies within a few ulp of a cdf step, where an ulp would pick
another bin."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.models import nerf_branch as jn
from pointnerf_tpu.models import renderer as jr
from pointnerf_tpu.models.renderer import RayBatch
from pointnerf_tpu.ops import query as jq
from pointnerf_tpu.train import step as js
from pointnerf_tpu_torch import config as tc
from pointnerf_tpu_torch.convert import (params_from_jax,
                                         point_cloud_from_numpy,
                                         train_state_from_jax)
from pointnerf_tpu_torch.models import nerf_branch as tn
from pointnerf_tpu_torch.models import renderer as tr
from pointnerf_tpu_torch.ops import query as tq
from pointnerf_tpu_torch.train import step as ts
from test_torch_render import _cfg, interpret_pallas, make_batch, setup  # noqa: F401
from test_torch_train import _assert_tree_close, _np

TOL = 2e-4
MARCH_BAR = 1e-5
ULP_MARGIN = 4      # a draw this many ulp from a cdf step is a near tie


def hybrid_cfg(ni=4, nc=16, fine=0, fused=True, jitter=0.0):
    cfg = _cfg(fused=fused)
    return cfg.replace(render=dataclasses.replace(
        cfg.render, nerf_importance=ni, nerf_coarse_samples=nc,
        nerf_hidden=32, nerf_layers=2, nerf_pe_xyz=4, nerf_pe_dir=2,
        fine_sample_num=fine, train_jitter=jitter))


def _far_from_steps(cdf, u):
    """No u within ULP_MARGIN ulp of a cdf entry (numpy, [R, S] / [R, n])."""
    gap = np.abs(cdf[:, None, :] - u[:, :, None])
    ulp = np.spacing(np.maximum(np.abs(cdf[:, None, :]), np.abs(u[:, :, None])))
    return bool((gap > ULP_MARGIN * ulp).all())


def _jax_inds(ts_, weights, u):
    """JAX's comparison-count bin indices (ops/query.sample_pdf) and its
    cdf."""
    def f(ts_, weights, u):
        w = weights[:, 1:-1] + 1e-5
        pdf = w / jnp.sum(w, axis=-1, keepdims=True)
        cdf = jnp.cumsum(pdf, axis=-1)
        cdf = jnp.concatenate([jnp.zeros_like(cdf[:, :1]), cdf], axis=-1)
        return (jnp.sum(cdf[:, None, :] <= u[:, :, None], axis=-1,
                        dtype=jnp.int32), cdf)
    inds, cdf = jax.jit(f)(ts_, weights, u)
    return np.asarray(inds), np.asarray(cdf)


def _pdf_case(seed, R=48, S=40):
    rng = np.random.RandomState(seed)
    ts_ = np.sort(rng.rand(R, S).astype(np.float32) * 2.5 + 2.0, -1)
    w = (rng.rand(R, S) ** 4).astype(np.float32)
    w[:, ::5] = 0.0
    return ts_, w


@pytest.mark.parametrize("det", [True, False])
@pytest.mark.parametrize("n", [9, 33])
def test_sample_pdf_matches_jax(det, n):
    ts_, w = _pdf_case(n)
    R = ts_.shape[0]
    key = jax.random.PRNGKey(n)
    u = (np.asarray(jax.random.uniform(key, (R, n), dtype=jnp.float32))
         if not det else np.broadcast_to(np.asarray(jnp.linspace(
             0.0, 1.0, n, dtype=jnp.float32)), (R, n)).copy())
    j_inds, j_cdf = _jax_inds(ts_, w, u)
    if not det:
        assert _far_from_steps(j_cdf, u)
    bins = torch.from_numpy(0.5 * (ts_[:, 1:] + ts_[:, :-1]))
    _s, t_inds = tq._inverse_cdf(bins, torch.from_numpy(w),
                                 torch.from_numpy(u))
    np.testing.assert_array_equal(t_inds.numpy(), j_inds)
    j = np.asarray(jax.jit(lambda a, b, k: jq.sample_pdf(
        a, b, n, det=det, key=k))(ts_, w, key))
    t = tq.sample_pdf(torch.from_numpy(ts_), torch.from_numpy(w), n,
                      det=det, u=None if det else torch.from_numpy(u)).numpy()
    assert t.shape == (R, n + ts_.shape[1])
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)


@pytest.mark.parametrize("jitter", [0.0, 0.3])
def test_refine_ray_generation_matches_jax(jitter):
    ts_, w = _pdf_case(1, R=32, S=24)
    R, pc = ts_.shape[0], 12
    rng = np.random.RandomState(2)
    cp = np.array([0.1, 0.2, -3.0], np.float32)
    rd = rng.randn(R, 3).astype(np.float32)
    key = jax.random.PRNGKey(4)
    pj, sj, mj = [np.asarray(a) for a in jax.jit(
        lambda c, r, a, b, k: jq.refine_ray_generation(
            c, r, pc, a, b, jitter=jitter, key=k))(cp, rd, ts_, w, key)]
    u = np.asarray(jax.random.uniform(key, (R, pc + 1), dtype=jnp.float32))
    pt, st_, mt = [a.numpy() for a in tq.refine_ray_generation(
        torch.from_numpy(cp), torch.from_numpy(rd), pc, torch.from_numpy(ts_),
        torch.from_numpy(w), jitter=jitter,
        u=torch.from_numpy(u) if jitter > 0 else None)]
    assert pt.shape == (R, pc + ts_.shape[1], 3)
    for a, b in ((pt, pj), (st_, sj), (mt, mj)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def _field(cfg, seed=3):
    p = jn.init_nerf_params(jax.random.PRNGKey(seed), cfg)
    return p, params_from_jax(jax.tree.map(np.asarray, p), device="cpu")


def _rays(R=48, seed=0):
    rng = np.random.RandomState(seed)
    cp = np.array([0.0, 0.0, -3.0], np.float32)
    rd = (rng.randn(R, 3) * 0.2 + np.array([0, 0, 1.0])).astype(np.float32)
    return cp, rd


def test_nerf_eval_matches_jax():
    cfg = hybrid_cfg()
    tcfg = tc.PointNeRFConfig.from_json(cfg.to_json())
    jp, tp = _field(cfg)
    rng = np.random.RandomState(5)
    xyz = rng.randn(40, 6, 3).astype(np.float32)
    vd = rng.randn(40, 6, 3).astype(np.float32)
    j = np.asarray(jax.jit(lambda a, b: jn.nerf_eval(jp, a, b, cfg))(xyz, vd))
    t = tn.nerf_eval(tp, torch.from_numpy(xyz), torch.from_numpy(vd),
                     tcfg).numpy()
    assert t.shape == (40, 6, 1 + 3)
    np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)
    # the sigma head's bias makes a fresh field near-transparent
    assert float(tp["sigma"]["b"][0]) == -3.0


def test_softplus_is_jax_form():
    x = np.array([-30.0, -3.0, 0.0, 3.0, 19.0, 25.0, 80.0], np.float32)
    np.testing.assert_allclose(tn._softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-6)


@pytest.mark.parametrize("train", [False, True])
def test_coarse_ray_march_and_importance_z_match_jax(train):
    cfg = hybrid_cfg()
    tcfg = tc.PointNeRFConfig.from_json(cfg.to_json())
    jp, tp = _field(cfg)
    cp, rd = _rays()
    R, Nc, Ni = rd.shape[0], 16, 4
    key = jax.random.PRNGKey(6)
    zj, wj, rj = [np.asarray(a) for a in jax.jit(
        lambda c, r, k: jn.coarse_ray_march(jp, c, r, cfg, key=k,
                                            train=train))(cp, rd, key)]
    u = np.asarray(jax.random.uniform(key, (R, Nc), dtype=jnp.float32))
    zt, wt, rt = [a.numpy() for a in tn.coarse_ray_march(
        tp, torch.from_numpy(cp), torch.from_numpy(rd), tcfg, train=train,
        u=torch.from_numpy(u))]
    np.testing.assert_array_equal(zt, zj)
    np.testing.assert_allclose(wt, wj, rtol=TOL, atol=TOL * wj.max())
    np.testing.assert_allclose(rt, rj, rtol=TOL, atol=TOL)
    # importance_z on JAX's weights: the draw's bins equal, samples close
    k2 = jax.random.PRNGKey(7)
    u2 = (np.asarray(jax.random.uniform(k2, (R, Ni), dtype=jnp.float32))
          if train else np.broadcast_to(np.asarray(jnp.linspace(
              0.02, 0.98, Ni, dtype=jnp.float32)), (R, Ni)).copy())
    j_inds, j_cdf = _jax_inds(zj, wj, u2)
    assert _far_from_steps(j_cdf, u2)
    _s, t_inds = tq._inverse_cdf(torch.from_numpy(0.5 * (zj[:, 1:]
                                                         + zj[:, :-1])),
                                 torch.from_numpy(wj), torch.from_numpy(u2))
    np.testing.assert_array_equal(t_inds.numpy(), j_inds)
    ij = np.asarray(jax.jit(lambda a, b, k: jn.importance_z(
        a, b, Ni, det=not train, key=k))(zj, wj, k2))
    it = tn.importance_z(torch.from_numpy(zj), torch.from_numpy(wj), Ni,
                         det=not train,
                         u=torch.from_numpy(u2) if train else None).numpy()
    np.testing.assert_allclose(it, ij, rtol=1e-6, atol=0)
    # the deterministic draw is jnp.linspace(0.02, 0.98, n) as compiled
    for n in (4, 8, 16, 64):
        np.testing.assert_array_equal(tq.linspace_f32(0.02, 0.98, n),
                                      np.asarray(jax.jit(lambda: jnp.linspace(
                                          0.02, 0.98, n,
                                          dtype=jnp.float32))()))


# ---- the whole render and train step -----------------------------------

def _scene(cfg, R=64, seed=0, gt=True):
    pc, st, params, grid, campos, camrot = setup(cfg, seed)
    params = dict(params)
    params["nerf"] = jn.init_nerf_params(jax.random.PRNGKey(3), cfg)
    item = make_batch(campos, camrot, R=R, seed=seed + 1)
    if gt:
        item["gt_image"] = np.random.RandomState(seed + 2).rand(
            R, 3).astype(np.float32)
    jb = RayBatch(campos=jnp.asarray(campos), camrotc2w=jnp.asarray(camrot),
                  raydir=jnp.asarray(item["raydir"]),
                  pixel_idx=jnp.asarray(item["pixel_idx"]),
                  near=jnp.asarray(2.0), far=jnp.asarray(4.5),
                  gt_image=jnp.asarray(item["gt_image"]) if gt else None)
    tcfg = tc.PointNeRFConfig.from_json(cfg.to_json())
    tpc, tst = point_cloud_from_numpy(*[np.asarray(a) for a in pc],
                                      num_active=int(st.num_active),
                                      device="cpu")
    tgrid, _ = ts.refresh_grid(tpc, tst, tcfg)
    tb = tr.ray_batch_from_numpy(item, tcfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return (params, pc, st, grid, jb), (tp, tpc, tst, tgrid, tb, tcfg)


def jax_draws(key, cfg, R):
    """The random draws of JAX render_rays(key=key, train=True)
    (models/renderer.py: split three ways when nerf_importance > 0; the
    hybrid splits its key again): (coarse jitter u, port draws)."""
    r = cfg.render
    if r.nerf_importance > 0:
        k_coarse, k_fine, k_nerf = jax.random.split(key, 3)
    else:
        k_coarse, k_fine = jax.random.split(key)
        k_nerf = None

    def uni(k, n):
        return torch.from_numpy(np.array(jax.random.uniform(
            k, (R, n), dtype=jnp.float32)))
    draws = {}
    if r.fine_sample_num > 0:
        draws["fine"] = uni(k_fine, r.fine_sample_num + 1)
    if k_nerf is not None:
        k1, k2 = jax.random.split(k_nerf)
        draws["nerf_march"] = uni(k1, r.nerf_coarse_samples)
        draws["nerf_importance"] = uni(k2, r.nerf_importance)
    return uni(k_coarse, cfg.query.z_depth_dim), draws


def _jax_merge(params, out, batch, cfg, train=False, key=None):
    """JAX's merge order idx_s, from its own pieces (the lines of
    renderer._hybrid_march), and its importance z's."""
    r = cfg.render
    k1 = k2 = None
    if key is not None:
        k1, k2 = jax.random.split(key)
    rd2 = jnp.sum(batch.raydir * batch.raydir, -1, keepdims=True)
    t_pts = jnp.sum((out.sample_loc_w - batch.campos[None, None, :])
                    * batch.raydir[:, None, :], -1) / rd2
    t_pts = jnp.where(out.ray_valid, t_pts, r.far_plane + 1.0)
    z_c, w_c, _ = jn.coarse_ray_march(params["nerf"], batch.campos,
                                      batch.raydir, cfg, key=k1, train=train)
    z_i = jn.importance_z(z_c, w_c, r.nerf_importance, det=not train, key=k2)
    z_all = jnp.concatenate([t_pts, z_i], -1)
    idx = jnp.broadcast_to(jnp.arange(z_all.shape[-1], dtype=jnp.int32)[None],
                           z_all.shape)
    _z, idx_s = jax.lax.sort((z_all, idx), num_keys=1)
    return np.asarray(idx_s), np.asarray(z_i)


_jax_render = jax.jit(jr.render_rays, static_argnames=("cfg", "train", "prob"))


@pytest.fixture
def record_merge(monkeypatch):
    seen = {}
    real = tr.merge_samples

    def rec(t_pts, valid, feats_p, z_i, feats_n):
        res = real(t_pts, valid, feats_p, z_i, feats_n)
        seen["idx_s"], seen["z_i"] = res[1], z_i
        return res
    monkeypatch.setattr(tr, "merge_samples", rec)
    return seen


HYBRID_FLOATS = ("coarse_raycolor", "coarse_is_background",
                 "nerf_coarse_raycolor", "nerf_mass", "nerf_loc_w",
                 "nerf_color")


def _render_pair(cfg, train=False, seed=0, R=64):
    (jp, pc, st, grid, jb), (tp, tpc, tst, tgrid, tb, tcfg) = _scene(
        cfg, R=R, seed=seed, gt=False)
    key = jax.random.PRNGKey(11) if train else None
    oj = _jax_render(jp, pc, st, grid, jb, cfg, key=key, train=train)
    u, draws = (jax_draws(key, cfg, R) if train else (None, None))
    with torch.no_grad():
        ot = tr.render_rays(tp, tpc, tst, tgrid, tb, tcfg, train=train, u=u,
                            draws=draws)
    k_nerf = jax.random.split(key, 3)[2] if train else None
    return oj, ot, _jax_merge(jp, oj, jb, cfg, train=train, key=k_nerf)


@pytest.mark.parametrize("train", [False, True])
def test_render_hybrid_matches_jax(interpret_pallas, record_merge, train):
    cfg = hybrid_cfg(jitter=0.3)
    oj, ot, (j_idx, j_zi) = _render_pair(cfg, train=train)
    np.testing.assert_allclose(record_merge["z_i"].numpy(), j_zi, rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(record_merge["idx_s"].numpy(), j_idx)
    for f in ("ray_valid", "ray_mask", "neighbor_pidx", "decode_dropped"):
        np.testing.assert_array_equal(getattr(ot, f).numpy(),
                                      np.asarray(getattr(oj, f)), err_msg=f)
    for f in HYBRID_FLOATS:
        a, b = getattr(ot, f).numpy(), np.asarray(getattr(oj, f))
        bar = MARCH_BAR if f in ("coarse_raycolor",
                                 "coarse_is_background") else TOL
        np.testing.assert_allclose(a, b, rtol=bar, atol=bar, err_msg=f)
    assert ot.sample_features is None
    # the merge interleaves: some field sample sits before a valid point
    SR = ot.ray_valid.shape[1]
    idx = record_merge["idx_s"].numpy()
    first_field = (idx >= SR).argmax(1)
    assert (first_field < ot.ray_valid.numpy().sum(1)).any()


@pytest.mark.parametrize("train", [False, True])
def test_fine_pass_matches_jax(interpret_pallas, train):
    cfg = hybrid_cfg(ni=0, fine=8, jitter=0.3)
    (jp, pc, st, grid, jb), (tp, tpc, tst, tgrid, tb, tcfg) = _scene(
        cfg, gt=False)
    key = jax.random.PRNGKey(12) if train else None
    oj = _jax_render(jp, pc, st, grid, jb, cfg, key=key, train=train)
    u, draws = jax_draws(key, cfg, 64) if train else (None, None)
    with torch.no_grad():
        ot = tr.render_rays(tp, tpc, tst, tgrid, tb, tcfg, train=train, u=u,
                            draws=draws)
    fj, ft = np.asarray(oj.fine_neighbor_pidx), ot.fine_neighbor_pidx.numpy()
    assert ft.shape == fj.shape and (ft >= 0).any()
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(ot.fine_raycolor.numpy(),
                               np.asarray(oj.fine_raycolor), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(ot.neighbor_pidx.numpy(),
                                  np.asarray(oj.neighbor_pidx))
    assert ot.nerf_coarse_raycolor is None


@pytest.mark.parametrize("fine,ni", [(0, 4), (8, 4)])
def test_train_step_matches_jax(interpret_pallas, fine, ni):
    """One train step from a fresh state with JAX's draws injected: the
    loss, the first Adam moments (0.1 x the gradients, the field's
    included), the second moments and the hit counters (the fine pass's
    neighbors counted too)."""
    cfg = hybrid_cfg(ni=ni, fine=fine, jitter=0.3)
    cfg = cfg.replace(
        loss=dataclasses.replace(
            cfg.loss,
            color_loss_items=("ray_masked_coarse_raycolor", "coarse_raycolor")
            + (("fine_raycolor",) if fine else ())
            + (("nerf_coarse_raycolor",) if ni else ()),
            color_loss_weights=(1.0, 1.0) + ((0.5,) if fine else ())
            + ((0.5,) if ni else ())),
        train=dataclasses.replace(cfg.train, track_hits=True))
    (jp, pc, st, grid, jb), (_tp, _tpc, tst, tgrid, tb, tcfg) = _scene(cfg)
    jstate = js.create_train_state(jax.random.PRNGKey(7), jp, pc, cfg)
    tstate = train_state_from_jax(_np(jstate), torch.Generator(),
                                  device="cpu")
    _key, sub = jax.random.split(jstate.key)
    u, draws = jax_draws(sub, cfg, 64)
    jnew, jout = js.train_step(jstate, st, grid, jb, cfg)
    tnew, tout = ts.train_step(tstate, tst, tgrid, tb, tcfg, u=u, draws=draws)
    for k in ("n_miss", "n_decode_dropped"):
        assert int(tout[k]) == int(jout[k]), k
    for k in ("loss_total", "psnr"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=TOL, err_msg=k)
    for g in ("mlp", "points"):
        inner = jnew.opt_state.inner_states[g].inner_state[0]
        assert int(tnew.opt_state[g].count) == int(inner.count)
        _assert_tree_close(tnew.opt_state[g].mu, inner.mu[g], f"{g} mu")
        _assert_tree_close(tnew.opt_state[g].nu, inner.nu[g], f"{g} nu")
    assert max(float(t.abs().max()) for t in jax.tree.leaves(
        tnew.opt_state["mlp"].mu["nerf"], is_leaf=torch.is_tensor)) > 0
    _assert_tree_close(tnew.hits, jnew.hits, "hits")


# ---- the cases of tests/test_nerf_hybrid.py, on the port ----------------

def _port_scene(cfg):
    return _scene(cfg, gt=False)[1]


def test_off_is_identity():
    """A params tree with an unused "nerf" subtree renders the same bits
    when the hybrid is off."""
    cfg = hybrid_cfg()
    tp, tpc, tst, tgrid, tb, tcfg = _port_scene(cfg)
    off = tcfg.replace(render=dataclasses.replace(tcfg.render,
                                                  nerf_importance=0))
    plain = {k: v for k, v in tp.items() if k != "nerf"}
    with torch.no_grad():
        o0 = tr.render_rays(plain, tpc, tst, tgrid, tb, off)
        o1 = tr.render_rays(tp, tpc, tst, tgrid, tb, off)
    assert torch.equal(o0.coarse_raycolor, o1.coarse_raycolor)
    assert o1.nerf_coarse_raycolor is None and o1.sample_features is None


def test_importance_z_in_range_and_peaked():
    z = torch.linspace(2.0, 6.0, 32)[None].expand(4, 32).contiguous()
    w = torch.zeros(4, 32)
    w[:, 20] = 10.0
    w[:, 21] = 10.0
    zi = tn.importance_z(z, w, 8, det=True).numpy()
    assert zi.shape == (4, 8)
    assert zi.min() >= 2.0 and zi.max() <= 6.0
    assert np.all(np.abs(zi - 4.65) < 0.6)


def test_hybrid_covers_missed_rays():
    cfg = hybrid_cfg()
    tp, tpc, tst, tgrid, tb, tcfg = _port_scene(cfg)
    with torch.no_grad():
        out = tr.render_rays(tp, tpc, tst, tgrid, tb, tcfg)
        off = tcfg.replace(render=dataclasses.replace(tcfg.render,
                                                      nerf_importance=0))
        out0 = tr.render_rays(tp, tpc, tst, tgrid, tb, off)
    assert out.nerf_coarse_raycolor.shape == out.coarse_raycolor.shape
    miss = ~out.ray_mask
    assert miss.any()
    # the points-only render fills missed rays with the background; the
    # field adds opacity there
    assert not torch.allclose(out.coarse_raycolor[miss],
                              out0.coarse_raycolor[miss])


def test_gradients_reach_both_branches():
    cfg = hybrid_cfg()
    tp, tpc, tst, tgrid, tb, tcfg = _port_scene(cfg)
    tb = tb._replace(gt_image=torch.rand(tb.raydir.shape[0], 3,
                                         generator=torch.Generator()
                                         .manual_seed(0)))
    from pointnerf_tpu_torch.train.optim import tree_leaves, tree_map
    p = tree_map(lambda t: t.detach().requires_grad_(), tp)
    feats = tpc.features.detach().requires_grad_()
    out = tr.render_rays(p, tpc._replace(features=feats), tst, tgrid, tb,
                         tcfg, train=True, generator=torch.Generator()
                         .manual_seed(1))
    loss = ((out.coarse_raycolor - tb.gt_image) ** 2).mean() + (
        (out.nerf_coarse_raycolor - tb.gt_image) ** 2).mean()
    loss.backward()
    nerf = sum(float(t.grad.abs().sum()) for t in tree_leaves(p["nerf"]))
    agg = sum(float(t.grad.abs().sum()) for k, v in p.items() if k != "nerf"
              for t in tree_leaves(v))
    assert nerf > 0 and agg > 0 and float(feats.grad.abs().sum()) > 0


def test_creation_signals_consistent():
    cfg = hybrid_cfg()
    tp, tpc, tst, tgrid, tb, tcfg = _port_scene(cfg)
    with torch.no_grad():
        out = tr.render_rays(tp, tpc, tst, tgrid, tb, tcfg)
    m = out.nerf_mass.numpy()
    assert m.shape == (64, 1)
    assert np.all(m >= 0.0) and np.all(m <= 1.0 + 1e-5)
    rd, cp = tb.raydir.numpy(), tb.campos.numpy()
    t = ((out.nerf_loc_w.numpy() - cp[None]) * rd).sum(-1) / (rd * rd).sum(-1)
    sig = m[:, 0] > 1e-3
    assert sig.any()
    assert t[sig].min() >= cfg.render.near_plane - 1e-3
    assert t[sig].max() <= cfg.render.far_plane + 1e-3


def test_nerf_create_points_candidates():
    """Probe accumulation turns confident field mass on missed rays into
    grow candidates at the field's expected location, as JAX's does
    (synthetic maps), and nothing with the switch off."""
    from pointnerf_tpu.train import grow as jg
    from pointnerf_tpu_torch.train import grow as tg
    cfg = hybrid_cfg()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, nerf_create_points=True, prob_thresh=0.5, prob_mul=0.4))
    tcfg = tc.PointNeRFConfig.from_json(cfg.to_json())
    H = W = 4
    n = H * W
    pix = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1).reshape(-1, 2)
    item = {"pixel_idx": pix, "gt_image": np.full((n, 3), 0.5, np.float32),
            "raydir": np.tile(np.array([0, 0, 1.0], np.float32), (n, 1))}
    F = cfg.agg.point_features_dim
    maps = {"ray_mask": np.zeros((H, W, 1), np.float32),
            "ray_max_shading_opacity": np.zeros((H, W, 1), np.float32),
            "ray_max_sample_loc_w": np.zeros((H, W, 3), np.float32),
            "shading_avg_embedding": np.zeros((H, W, F), np.float32),
            "shading_avg_color": np.zeros((H, W, 3), np.float32),
            "shading_avg_dir": np.zeros((H, W, 3), np.float32),
            "shading_avg_conf": np.zeros((H, W, 1), np.float32),
            "nerf_mass": np.zeros((H, W, 1), np.float32),
            "nerf_loc_w": np.zeros((H, W, 3), np.float32),
            "nerf_color": np.zeros((H, W, 3), np.float32)}
    maps["nerf_mass"][1, 2, 0] = 0.9
    maps["nerf_mass"][3, 0, 0] = 0.6
    maps["nerf_mass"][0, 0, 0] = 0.4               # under prob_thresh
    maps["nerf_loc_w"][1, 2] = [0.1, 0.2, 3.0]
    maps["nerf_color"][1, 2] = [1.0, 0.0, 0.0]
    bg = np.ones(3, np.float32)
    cands = []
    for mod, c in ((jg, cfg), (tg, tcfg)):
        adds = {k: [] for k in ("xyz", "embedding", "color", "dirs", "conf")}
        mod.accumulate_probe_candidates(adds, maps, item, c, (W, H), bg)
        cands.append(mod.finalize_probe_candidates(adds, c))
    cj, ct = cands
    assert ct.xyz.shape == (2, 3)
    for f in ("xyz", "embedding", "color", "dirs", "conf"):
        np.testing.assert_array_equal(getattr(ct, f), getattr(cj, f))
    np.testing.assert_allclose(ct.conf[0], [0.9 * 0.4], rtol=1e-6)
    off = tcfg.replace(train=dataclasses.replace(tcfg.train,
                                                 nerf_create_points=False))
    adds = {k: [] for k in ("xyz", "embedding", "color", "dirs", "conf")}
    tg.accumulate_probe_candidates(adds, maps, item, off, (W, H), bg)
    assert tg.finalize_probe_candidates(adds, off).xyz.shape == (0, 3)
