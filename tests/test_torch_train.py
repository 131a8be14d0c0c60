"""The port's training step (pointnerf_tpu_torch/train) against the JAX
package's, with the same weights, cloud, optimizer state
(convert.train_state_from_jax), rays and jitter draw.

Config: the tiny_test_config of tests/test_torch_render.py (prebuilt
neighbor tables, decode_capacity=0.5, knn_select="pallas", fused_march),
f32. The JAX Pallas kernels run in interpret mode; the port's run their
plain versions on CPU tensors. Bars: 2e-4 relative for the loss, the
gradients and the Adam moments (the gradient bar of PERF.md "Numerical
parity"); integer outputs equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.models.renderer import RayBatch
from pointnerf_tpu.train import step as js
from pointnerf_tpu_torch import config as tc
from pointnerf_tpu_torch.convert import train_state_from_jax
from pointnerf_tpu_torch.models import renderer as tr
from pointnerf_tpu_torch.train import step as ts
from test_torch_render import _cfg, interpret_pallas, make_batch, setup  # noqa: F401

TOL = 2e-4


def _train_cfg(fused=True, track_hits=False, jitter=0.3, alter_step=0):
    cfg = _cfg(fused=fused)
    return cfg.replace(
        render=dataclasses.replace(cfg.render, train_jitter=jitter),
        train=dataclasses.replace(cfg.train, track_hits=track_hits,
                                  hit_lr_boost=2.0 if track_hits else 0.0,
                                  alter_step=alter_step))


def _scene(cfg, R=64, seed=0):
    pc, st, params, grid, campos, camrot = setup(cfg, seed)
    item = make_batch(campos, camrot, R=R, seed=seed + 1)
    item["gt_image"] = np.random.RandomState(seed + 2).rand(R, 3).astype(
        np.float32)
    jb = RayBatch(campos=jnp.asarray(campos), camrotc2w=jnp.asarray(camrot),
                  raydir=jnp.asarray(item["raydir"]),
                  pixel_idx=jnp.asarray(item["pixel_idx"]),
                  near=jnp.asarray(2.0), far=jnp.asarray(4.5),
                  gt_image=jnp.asarray(item["gt_image"]))
    tcfg = tc.PointNeRFConfig.from_json(cfg.to_json())
    tb = tr.ray_batch_from_numpy(item, tcfg, device="cpu")
    tgrid, _ = ts.refresh_grid(*_port_cloud(pc, st), tcfg)
    return pc, st, params, grid, jb, tcfg, tb, tgrid


def _port_cloud(pc, st):
    from pointnerf_tpu_torch.convert import point_cloud_from_numpy
    return point_cloud_from_numpy(*[np.asarray(a) for a in pc],
                                  num_active=int(st.num_active), device="cpu")


def _jax_u(key, cfg, R):
    """The jitter draw of JAX train_step at this key (train/step.py and
    models/renderer.py: split, split, uniform)."""
    _key, sub = jax.random.split(key)
    k_coarse, _k_fine = jax.random.split(sub)
    return np.asarray(jax.random.uniform(k_coarse, (R, cfg.query.z_depth_dim),
                                         dtype=jnp.float32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(t_tree, j_tree, what, tol=TOL):
    tl = [t for t in jax.tree.leaves(t_tree, is_leaf=torch.is_tensor)]
    jl = jax.tree.leaves(j_tree)
    assert len(tl) == len(jl), what
    for i, (a, b) in enumerate(zip(tl, jl)):
        a, b = a.detach().numpy(), np.asarray(b)
        assert a.shape == b.shape, (what, i)
        scale = max(float(np.abs(b).max()), 1e-12)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale,
                                   err_msg=f"{what} leaf {i}")


def test_jittered_ray_depths_match_jax():
    """Jittered depths with JAX's own draw: equal to the compiled JAX
    generator's (the bar is 2 ulp; they come out bit-equal), slot masks
    equal."""
    from pointnerf_tpu.ops.query import generate_shading_points as j_gen
    from pointnerf_tpu.ops.query import near_far_linear_ray_generation as j_rays
    from pointnerf_tpu_torch.ops import query as tq
    rng = np.random.RandomState(11)
    cp = np.array([0.3, 0.8, -3.0], np.float32)
    for D, R, near, far in ((64, 32, 2.0, 4.5), (400, 16, 2.0, 4.5),
                            (100, 24, 0.5, 6.0), (17, 8, 2.0, 4.5)):
        rd = rng.randn(R, 3).astype(np.float32)
        key = jax.random.PRNGKey(D)
        _, seg_j, mid_j = jax.jit(lambda c, r, k: j_rays(
            c, r, D, near, far, jitter=0.3, key=k))(cp, rd, key)
        u = np.array(jax.random.uniform(key, (R, D), dtype=jnp.float32))
        _, seg_t, mid_t = tq.near_far_linear_ray_generation(
            torch.from_numpy(cp), torch.from_numpy(rd), D, near, far,
            jitter=0.3, u=torch.from_numpy(u))
        mid_j = np.asarray(mid_j)
        assert np.all(np.abs(mid_t.numpy() - mid_j) <= 2 * np.spacing(mid_j))
        np.testing.assert_allclose(seg_t.numpy(), np.asarray(seg_j),
                                   rtol=1e-6, atol=0)
    cfg = _train_cfg()
    pc, st, params, grid, jb, tcfg, tb, tgrid = _scene(cfg)
    key = jax.random.PRNGKey(5)
    u = np.asarray(jax.random.uniform(key, (64, cfg.query.z_depth_dim)))
    lj, mj = jax.jit(lambda c, r, k: j_gen(grid, c, r, 2.0, 4.5, cfg.query,
                                           jitter=0.3, key=k))(
        jb.campos, jb.raydir, key)
    lt, mt = tq.generate_shading_points(tgrid, tb.campos, tb.raydir, 2.0, 4.5,
                                        tcfg.query, jitter=0.3,
                                        u=torch.from_numpy(u))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert mt.numpy().any()
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-6)


def test_jitter_draws_from_the_generator():
    from pointnerf_tpu_torch.ops import query as tq
    rd = torch.randn(8, 3)
    cp = torch.tensor([0.0, 0.0, -3.0])
    a = tq.near_far_linear_ray_generation(
        cp, rd, 32, 2.0, 4.5, jitter=0.3,
        generator=torch.Generator().manual_seed(3))[2]
    b = tq.near_far_linear_ray_generation(
        cp, rd, 32, 2.0, 4.5, jitter=0.3,
        generator=torch.Generator().manual_seed(3))[2]
    c = tq.near_far_linear_ray_generation(cp, rd, 32, 2.0, 4.5)[2]
    assert torch.equal(a, b) and not torch.equal(a, c)
    # no draw, no jitter (JAX: no key)
    d = tq.near_far_linear_ray_generation(cp, rd, 32, 2.0, 4.5, jitter=0.3)[2]
    assert torch.equal(d, c)


def _render_out(seed=0, R=32, SR=6, K=4):
    rng = np.random.RandomState(seed)
    ray_mask = rng.rand(R) > 0.3
    valid = (rng.rand(R, SR) > 0.4) & ray_mask[:, None]
    weight = (rng.rand(R, SR, K) * (rng.rand(R, SR, K) > 0.3)).astype(
        np.float32)
    return dict(
        coarse_raycolor=rng.rand(R, 3).astype(np.float32),
        coarse_is_background=rng.rand(R, 1).astype(np.float32),
        coarse_depth=(2 + rng.rand(R, 1)).astype(np.float32),
        coarse_point_opacity=rng.rand(R, SR).astype(np.float32),
        queried_shading=np.zeros((R, 1), np.float32), ray_mask=ray_mask,
        weight=weight, conf_coefficient=rng.rand(R, SR, K).astype(np.float32),
        ray_valid=valid, sample_loc_w=rng.rand(R, SR, 3).astype(np.float32))


def test_compute_losses_every_item_kind():
    from pointnerf_tpu.config import LossConfig
    from pointnerf_tpu.models.losses import compute_losses as j_losses
    from pointnerf_tpu.models.renderer import RenderOutput as JOut
    from pointnerf_tpu_torch.models.losses import compute_losses, mse2psnr
    lc = LossConfig(
        color_loss_items=("ray_masked_coarse_raycolor",
                          "ray_miss_coarse_raycolor", "coarse_raycolor"),
        color_loss_weights=(1.0, 0.5, 0.25),
        zero_one_loss_items=("conf_coefficient",),
        zero_one_loss_weights=(0.01,), sparse_loss_weight=0.1,
        depth_loss_items=("ray_depth_masked_coarse_depth",),
        depth_loss_weights=(0.3,), bg_loss_items=("coarse_is_background",),
        bg_loss_weights=(0.2,))
    d = _render_out()
    rng = np.random.RandomState(3)
    gt = rng.rand(32, 3).astype(np.float32)
    gt[:4] = 1.0                                     # background pixels
    gt_depth = (2 + rng.rand(32)).astype(np.float32)
    gt_depth[5:9] = 0.0
    bg = np.ones(3, np.float32)
    tj, ij = j_losses(JOut(**{k: jnp.asarray(v) for k, v in d.items()}),
                      jnp.asarray(gt), lc, gt_depth=jnp.asarray(gt_depth),
                      bg_color=jnp.asarray(bg))
    tlc = tc.LossConfig(**dataclasses.asdict(lc))
    tt, it = compute_losses(
        tr.RenderOutput(**{k: torch.from_numpy(v) for k, v in d.items()}),
        torch.from_numpy(gt), tlc, gt_depth=torch.from_numpy(gt_depth),
        bg_color=torch.from_numpy(bg))
    assert set(it) == set(ij) and len(it) == 7
    for k in ij:
        np.testing.assert_allclose(it[k].numpy(), np.asarray(ij[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-6)
    np.testing.assert_allclose(mse2psnr(torch.tensor(0.01)).numpy(), 20.0,
                               rtol=1e-6)


def test_alternated_update_holds_the_off_phase():
    """alter_step > 0: the off-phase group's moments and count are carried
    through unchanged and its update is zero, as in JAX."""
    from pointnerf_tpu.config import tiny_test_config
    from pointnerf_tpu.train.optim import alternated_update as j_alt
    from pointnerf_tpu.train.optim import make_optimizer
    from pointnerf_tpu_torch.train import optim as to
    cfg = tiny_test_config()
    rng = np.random.RandomState(0)
    params = {"mlp": {"block1": [{"w": rng.randn(3, 2).astype(np.float32),
                                  "b": rng.randn(2).astype(np.float32)}]},
              "points": {"features": rng.randn(5, 4).astype(np.float32)}}
    tx = make_optimizer(cfg)
    jstate = tx.init(jax.tree.map(jnp.asarray, params))
    tstate = to.init_optimizer(jax.tree.map(torch.from_numpy, params))
    tcfg = tc.PointNeRFConfig.from_json(cfg.to_json())
    for step in range(5):
        g = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32),
                         params)
        ju, jstate = j_alt(tx, jax.tree.map(jnp.asarray, g), jstate,
                           jax.tree.map(jnp.asarray, params),
                           jnp.asarray(step, jnp.int32), 2)
        tu, tstate = to.alternated_update(
            jax.tree.map(torch.from_numpy, g), tstate,
            torch.tensor(step, dtype=torch.int32), 2, tcfg)
        mlp_on = (step // 2) % 2 == 0
        for grp, on in (("mlp", mlp_on), ("points", not mlp_on)):
            inner = jstate.inner_states[grp].inner_state[0]
            assert int(tstate[grp].count) == int(inner.count)
            _assert_tree_close(tstate[grp].mu, inner.mu[grp], "mu", 1e-6)
            _assert_tree_close(tstate[grp].nu, inner.nu[grp], "nu", 1e-6)
            _assert_tree_close(tu[grp], ju[grp], "updates", 1e-5)
            if not on:
                assert all(float(t.abs().max()) == 0
                           for t in jax.tree.leaves(tu[grp],
                                                    is_leaf=torch.is_tensor))
    # after 5 steps (phases 0,0,1,1,0): mlp updated 3 times, points twice
    assert int(tstate["mlp"].count) == 3 and int(tstate["points"].count) == 2


def test_gather_bwd_scatter_and_sort_agree():
    from pointnerf_tpu.models.points import gather_points as j_gather
    from pointnerf_tpu.models.points import PointCloud as JPC
    from pointnerf_tpu_torch.models.points import PointCloud, gather_points
    rng = np.random.RandomState(0)
    N, F = 40, 6
    arrs = [rng.randn(N, n).astype(np.float32) for n in (3, F, 1, 3, 3)]
    pers = rng.randn(N, 3).astype(np.float32)
    pidx = rng.randint(-1, N, size=(9, 5, 4)).astype(np.int32)
    ct = rng.randn(9, 5, 4, 13 + F).astype(np.float32)

    def jloss(pc, pers, bwd):
        sp = j_gather(pc, pers, jnp.asarray(pidx), bwd=bwd)
        rows = jnp.concatenate([sp.xyz, sp.xyz_pers, sp.features, sp.conf,
                                sp.color, sp.dirs], -1)
        return jnp.sum(rows * ct)
    gj = jax.grad(jloss, argnums=(0, 1))(JPC(*map(jnp.asarray, arrs)),
                                         jnp.asarray(pers), "sort")
    grads = {}
    for bwd in ("scatter", "sort"):
        pc = PointCloud(*[torch.from_numpy(a).requires_grad_() for a in arrs])
        tp = torch.from_numpy(pers).requires_grad_()
        sp = gather_points(pc, tp, torch.from_numpy(pidx), bwd=bwd)
        rows = torch.cat([sp.xyz, sp.xyz_pers, sp.features, sp.conf,
                          sp.color, sp.dirs], -1)
        (rows * torch.from_numpy(ct)).sum().backward()
        grads[bwd] = [t.grad for t in list(pc) + [tp]]
    for a, b, j in zip(grads["scatter"], grads["sort"],
                       list(gj[0]) + [gj[1]]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(b.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)


def _warm_jax_state(cfg, params, pc, grid, st, jb, steps=2):
    """A JAX TrainState after `steps` steps: non-zero moments and hits."""
    state = js.create_train_state(jax.random.PRNGKey(7), params, pc, cfg)
    for _ in range(steps):
        state, _items = js.train_step(state, st, grid, jb, cfg)
    return _np(state)


@pytest.mark.parametrize("track_hits", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_train_step_matches_jax(interpret_pallas, fused, track_hits):
    cfg = _train_cfg(fused=fused, track_hits=track_hits)
    pc, st, params, grid, jb, tcfg, tb, tgrid = _scene(cfg)
    state_np = _warm_jax_state(cfg, params, pc, grid, st, jb)
    tstate = train_state_from_jax(state_np, torch.Generator(), device="cpu")
    jstate = jax.tree.map(jnp.asarray, state_np)
    u = _jax_u(jstate.key, cfg, 64)

    # gradients of the loss at this state, before the grad flags
    _key, sub = jax.random.split(jstate.key)
    (jtot, jitems), jgrads = jax.jit(lambda p, k: jax.value_and_grad(
        js.loss_fn, has_aux=True)(p, st, grid, jb, cfg, k))(jstate.params, sub)
    ttot, titems, tgrads = ts.loss_and_grads(
        tstate.params, _port_st(st), tgrid, tb, tcfg,
        u=torch.from_numpy(u))
    np.testing.assert_allclose(ttot.numpy(), np.asarray(jtot), rtol=TOL)
    _assert_tree_close(tgrads["mlp"], jgrads["mlp"], "mlp grads")
    _assert_tree_close(tgrads["points"].features, jgrads["points"].features,
                       "feature grads")
    _assert_tree_close(tgrads["points"].conf, jgrads["points"].conf,
                       "conf grads")
    _assert_tree_close(tgrads["points"].color, jgrads["points"].color,
                       "color grads")
    _assert_tree_close(tgrads["points"].dirs, jgrads["points"].dirs,
                       "dir grads")

    jnew, jout = js.train_step(jstate, st, grid, jb, cfg)
    tnew, tout = ts.train_step(tstate, _port_st(st), tgrid, tb, tcfg,
                               u=torch.from_numpy(u))
    for k in ("n_miss", "n_decode_dropped"):
        assert int(tout[k]) == int(jout[k]), k
    for k in ("loss_total", "psnr", "psnr_masked", "per_ray_err"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=TOL, atol=1e-6, err_msg=k)
    assert int(tnew.step) == int(jnew.step)
    for g in ("mlp", "points"):
        inner = jnew.opt_state.inner_states[g].inner_state[0]
        assert int(tnew.opt_state[g].count) == int(inner.count)
        _assert_tree_close(tnew.opt_state[g].mu, inner.mu[g], f"{g} mu")
        _assert_tree_close(tnew.opt_state[g].nu, inner.nu[g], f"{g} nu")
    if track_hits:
        _assert_tree_close(tnew.hits, jnew.hits, "hits")
    # updated params: Adam turns tiny noisy gradients into steps of +-lr
    # whatever their size, so params are compared where |g_jax| > 1e-6
    g_all = jax.tree.leaves({"mlp": jgrads["mlp"],
                             "points": jgrads["points"]})
    p_t = jax.tree.leaves(tnew.params, is_leaf=torch.is_tensor)
    p_j = jax.tree.leaves(jnew.params)
    assert len(g_all) == len(p_t) == len(p_j)
    for g, a, b in zip(g_all, p_t, p_j):
        sel = np.abs(np.asarray(g)) > 1e-6
        np.testing.assert_allclose(a.numpy()[sel], np.asarray(b)[sel],
                                   rtol=TOL, atol=1e-6)


def _port_st(st):
    from pointnerf_tpu_torch.models.points import PointCloudStatic
    return PointCloudStatic(num_active=torch.tensor(int(st.num_active),
                                                    dtype=torch.int32),
                            Rw2c=torch.from_numpy(np.asarray(st.Rw2c)))


def test_loss_curve_matches_jax(interpret_pallas):
    """20 steps on one batch without jitter: the port's losses follow JAX's
    and fall."""
    cfg = _train_cfg(jitter=0.0)
    pc, st, params, grid, jb, tcfg, tb, tgrid = _scene(cfg)
    jstate = js.create_train_state(jax.random.PRNGKey(7), params, pc, cfg)
    tstate = train_state_from_jax(_np(jstate), torch.Generator(),
                                  device="cpu")
    tst = _port_st(st)
    lj, lt = [], []
    for _ in range(20):
        jstate, ji = js.train_step(jstate, st, grid, jb, cfg)
        tstate, ti = ts.train_step(tstate, tst, tgrid, tb, tcfg)
        lj.append(float(ji["loss_total"]))
        lt.append(float(ti["loss_total"]))
    np.testing.assert_allclose(lt, lj, rtol=1e-3)
    assert np.mean(lt[-5:]) < np.mean(lt[:5])
