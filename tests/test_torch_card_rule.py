"""The JAX package's own default configuration through the port, and the
card's rule for the kernels (ROADMAP "Rules for the port").

- tiny_test_config() as it is — bucket rows, the shell-layered KNN, the
  dense decode, both fused flags off — renders and trains as JAX's
  eval_step / train_step do: integers equal, pixels, the loss and the
  gradients within 2e-4; and train_scene runs on it.
- On CUDA the decode takes K3 (and K4 under a gradient) whenever the config
  lies inside the fused envelope (the general kernels past the tuned
  kernels' limits), and serving takes
  K2 whenever it computes the march, whatever the fused flags say; outside
  the envelope the card runs the unfused torch decode (JAX's XLA branch).
  On the CPU the flags decide, as in JAX. The card is faked by passing a
  CUDA device to the route predicates (no card is needed to decide a route).
- The unfused decode against the fused one's plain version in f32, within
  2e-4 of scale; in bf16 against JAX's unfused (XLA) decode, at the bf16
  bar of the plain-vs-JAX decode tests."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.config import tiny_test_config
from pointnerf_tpu.models.aggregator import aggregate as j_aggregate
from pointnerf_tpu.models.points import SampledPoints as JSP
from pointnerf_tpu.train import step as js
from pointnerf_tpu_torch import config as tc
from pointnerf_tpu_torch.convert import params_from_jax, train_state_from_jax
from pointnerf_tpu_torch.models import aggregator as ta
from pointnerf_tpu_torch.models import renderer as tr
from pointnerf_tpu_torch.models.points import SampledPoints as TSP
from pointnerf_tpu_torch.ops.fused_march import MAX_C
from pointnerf_tpu_torch.train import step as ts
from test_torch_decode import BF16_TOL, _case
from test_torch_dense import _assert_outputs
from test_torch_render import (FLOATS, INTS, _render_both,
                               interpret_pallas)  # noqa: F401
from test_torch_train import (TOL, _assert_tree_close, _jax_u, _port_st,
                              _scene, _warm_jax_state)

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


def test_eval_step_default_config_matches_jax():
    """tiny_test_config() unchanged: the bucket / shell-layered query, the
    dense decode through the unfused branch and the plain march, as JAX
    runs them."""
    cfg = tiny_test_config()
    assert not (cfg.query.prebuild_neighbors or cfg.agg.fused_decode
                or cfg.render.fused_march) and cfg.query.shell_layered
    oj, ot = _render_both(cfg)
    _assert_outputs(oj, ot, [f for f in INTS if f != "decode_dropped"],
                    FLOATS)
    assert ot.ray_mask.any() and not ot.ray_mask.all()


def test_train_step_default_config_matches_jax():
    """One train step of tiny_test_config() unchanged (jittered with JAX's
    draw) from a warm JAX state: loss, every gradient, the Adam moments and
    the step's counts as JAX's."""
    cfg = tiny_test_config()
    pc, st, params, grid, jb, tcfg, tb, tgrid = _scene(cfg)
    state_np = _warm_jax_state(cfg, params, pc, grid, st, jb)
    tstate = train_state_from_jax(state_np, torch.Generator(), device="cpu")
    jstate = jax.tree.map(jnp.asarray, state_np)
    u = torch.from_numpy(_jax_u(jstate.key, cfg, 64))
    _key, sub = jax.random.split(jstate.key)
    (jtot, _ji), jgrads = jax.jit(lambda p, k: jax.value_and_grad(
        js.loss_fn, has_aux=True)(p, st, grid, jb, cfg, k))(jstate.params, sub)
    ttot, _ti, tgrads = ts.loss_and_grads(tstate.params, _port_st(st), tgrid,
                                          tb, tcfg, u=u)
    np.testing.assert_allclose(ttot.numpy(), np.asarray(jtot), rtol=TOL)
    _assert_tree_close(tgrads["mlp"], jgrads["mlp"], "mlp grads")
    for f in ("features", "conf", "color", "dirs"):
        _assert_tree_close(getattr(tgrads["points"], f),
                           getattr(jgrads["points"], f), f"{f} grads")
    jnew, jout = js.train_step(jstate, st, grid, jb, cfg)
    tnew, tout = ts.train_step(tstate, _port_st(st), tgrid, tb, tcfg, u=u)
    assert int(tout["n_miss"]) == int(jout["n_miss"])
    np.testing.assert_allclose(tout["loss_total"].numpy(),
                               np.asarray(jout["loss_total"]), rtol=TOL)
    for g in ("mlp", "points"):
        inner = jnew.opt_state.inner_states[g].inner_state[0]
        _assert_tree_close(tnew.opt_state[g].mu, inner.mu[g], f"{g} mu")


def test_train_scene_runs_the_default_config(tmp_path):
    """train_scene(tiny_test_config()) on the CPU: the configuration the
    port refused before runs its schedule to the end."""
    from pointnerf_tpu_torch.data.synthetic import (ring_cameras, sphere_scene,
                                                    view_ray_batch)
    from pointnerf_tpu_torch.train.driver import train_scene
    cfg = tiny_test_config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, maximum_step=4, prune_iter=2, prune_max_iter=4,
        test_freq=4, print_freq=1, save_iter_freq=0))
    xyz, color, normals = sphere_scene(n_pts=600, radius=0.6)
    views = ring_cameras(n_views=2, wh=(16, 16), focal=20.0)

    def item(step):
        return view_ray_batch(*views[step % 2], (16, 16), n_rays=64,
                              seed=step, radius=0.6, view_id=step % 2)
    state, _st, hist = train_scene(
        cfg, (xyz, color, normals), item, [view_ray_batch(
            *views[1], (16, 16), radius=0.6)], [], (16, 16),
        run_dir=str(tmp_path / "run"), device="cpu")
    assert int(state.step) == 4 and len(hist["loss"]) == 4
    assert np.isfinite(hist["eval"][0]["psnr"])


def _agg(**kw):
    return dataclasses.replace(tc.tiny_test_config().agg, **kw)


@pytest.mark.parametrize("bf16", [False, True])
def test_decode_route_on_the_card(bf16):
    """decode_takes_kernel: the kernels inside the envelope whatever the
    flag on CUDA, the flag on the CPU, the unfused decode outside the
    envelope. Inside the envelope past the tuned kernels' limits (H = 512,
    K = 6) the card takes the general kernels, whatever the flag: no spec
    is refused."""
    from pointnerf_tpu_torch.ops.fused_decode import route
    pick = ta.decode_takes_kernel
    for flag in (True, False):
        assert pick(_agg(fused_decode=flag), CUDA)
        assert pick(_agg(fused_decode=flag), CPU) == flag
        for outside in (dict(act_super=0), dict(act_type="ReLU"),
                        dict(shading_feature_mlp_layer2=1),
                        dict(agg_intrp_order=1)):
            assert not pick(_agg(fused_decode=flag, **outside), CUDA)
            assert not pick(_agg(fused_decode=flag, **outside), CPU)
    for flag in (True, False):
        for agg, K in ((_agg(fused_decode=flag, shading_feature_num=512), 4),
                       (_agg(fused_decode=flag), 6)):
            assert pick(agg, CUDA)
            spec = ta.decode_spec(agg, K, bf16=bf16)
            assert route(spec) == route(spec, backward=True) == "general"
            assert pick(agg, CPU) == flag


def test_march_route_on_the_card():
    """march_takes_kernel: K2 for every radiance / alpha render served on
    CUDA whatever the flag, at any channel count (past the tiled kernel's
    MAX_C, the 2D heads' C = 128, the wide kernel), never in training, the
    flag on the CPU."""
    cfg = tc.tiny_test_config()
    for flag in (True, False):
        c = cfg.replace(render=dataclasses.replace(cfg.render,
                                                   fused_march=flag))
        assert tr.march_takes_kernel(c, CUDA, train=False)
        assert not tr.march_takes_kernel(c, CUDA, train=True)
        assert tr.march_takes_kernel(c, CPU, train=False) == flag
    for C in (MAX_C + 1, 128):
        wide = cfg.replace(agg=dataclasses.replace(
            cfg.agg, shading_color_channel_num=C))
        for flag in (True, False):
            c = wide.replace(render=dataclasses.replace(wide.render,
                                                        fused_march=flag))
            assert tr.march_takes_kernel(c, CUDA, train=False)
            tr.check_envelope(c, CUDA)
            assert not tr.march_takes_kernel(c, CUDA, train=True)
            assert tr.march_takes_kernel(c, CPU, train=False) == flag
    other = cfg.replace(render=dataclasses.replace(
        cfg.render, which_blend_func="add"))
    assert not tr.march_takes_kernel(other, CUDA, train=False)
    with pytest.raises(ValueError, match="fused_march supports only"):
        tr.march_takes_kernel(other.replace(render=dataclasses.replace(
            other.render, fused_march=True)), CUDA, train=False)


def test_card_route_runs_the_kernels_with_the_flags_off(interpret_pallas,
                                                        monkeypatch):
    """A render of tiny_test_config() (flags off) with the route predicates
    seeing a card calls the decode kernel's and K2's entry points (their
    plain versions here, on CPU tensors) and gives what the CPU run with
    the flags set gives, bit for bit."""
    cfg = tiny_test_config()
    calls = {"fused_decode": 0, "fused_march": 0}
    real_dec, real_march = ta.fused_decode, tr.fused_march

    def dec(*a, **k):
        calls["fused_decode"] += 1
        return real_dec(*a, **k)

    def march(*a, **k):
        calls["fused_march"] += 1
        return real_march(*a, **k)
    _oj, off = _render_both(cfg)
    assert calls == {"fused_decode": 0, "fused_march": 0}
    real_pick_d, real_pick_m = ta.decode_takes_kernel, tr.march_takes_kernel
    monkeypatch.setattr(ta, "fused_decode", dec)
    monkeypatch.setattr(tr, "fused_march", march)
    monkeypatch.setattr(ta, "decode_takes_kernel",
                        lambda c, _d: real_pick_d(c, CUDA))
    monkeypatch.setattr(tr, "march_takes_kernel",
                        lambda c, _d, train: real_pick_m(c, CUDA, train))
    _oj, card = _render_both(cfg)
    assert calls["fused_decode"] == 1 and calls["fused_march"] == 1
    monkeypatch.setattr(ta, "decode_takes_kernel", real_pick_d)
    monkeypatch.setattr(tr, "march_takes_kernel", real_pick_m)
    on = cfg.replace(agg=dataclasses.replace(cfg.agg, fused_decode=True),
                     render=dataclasses.replace(cfg.render, fused_march=True))
    _oj, flags = _render_both(on)
    for f in ("coarse_raycolor", "coarse_point_opacity", "coarse_depth",
              "neighbor_pidx", "ray_mask"):
        assert torch.equal(getattr(card, f), getattr(flags, f)), f
    np.testing.assert_allclose(card.coarse_raycolor.numpy(),
                               off.coarse_raycolor.numpy(), rtol=0,
                               atol=2e-4)


def _features(fused, dtype, seed, K):
    cfg, params, sp, sl, slw, rd = _case(seed=seed, R=24, SR=10, K=K)
    c = tc.PointNeRFConfig.from_json(cfg.replace(agg=dataclasses.replace(
        cfg.agg, fused_decode=fused)).to_json())
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    spt = TSP(**{k: torch.from_numpy(v.copy()) for k, v in sp.items()})
    return ta.aggregate(tp, c.agg, spt, torch.from_numpy(sl.copy()),
                        torch.from_numpy(slw.copy()),
                        torch.from_numpy(rd.copy()), c.query.vsize,
                        Rw2c=torch.eye(3), compute_dtype=dtype).features


@pytest.mark.parametrize("K", [4, 8])
@pytest.mark.parametrize("seed", [0, 3])
def test_unfused_decode_against_the_fused_plain_version(seed, K):
    """f32: the unfused branch computes the fused decode's function, within
    2e-4 of scale of its plain version."""
    ref = _features(True, torch.float32, seed, K)
    err = float((_features(False, torch.float32, seed, K) - ref).abs().max())
    assert err <= TOL * float(ref.abs().max())


@pytest.mark.parametrize("K", [4, 8])
@pytest.mark.parametrize("seed", [0, 3])
def test_unfused_decode_bf16_matches_jax_unfused(seed, K):
    """bf16: the port's unfused branch against JAX's unfused (XLA) branch on
    the same inputs, at the bf16 decode bar of the plain-vs-JAX tests (2e-2
    of the output scale). Readings on _case inputs (seeds 0-5, K 4 and 8):
    3.9e-3 to 8.9e-3. The port's f32 decode reads about the same against
    JAX's bf16 one (5.3e-3 to 8.8e-3): the bar holds the function, not
    where the two round."""
    cfg, params, sp, sl, slw, rd = _case(seed=seed, R=24, SR=10, K=K)
    c = cfg.replace(agg=dataclasses.replace(cfg.agg, fused_decode=False))
    ref = np.asarray(j_aggregate(
        params, c.agg, JSP(**{k: jnp.asarray(v.copy()) for k, v in sp.items()}),
        jnp.asarray(sl.copy()), jnp.asarray(slw.copy()),
        jnp.asarray(rd.copy()), c.query.vsize, Rw2c=jnp.eye(3),
        compute_dtype=jnp.bfloat16).features.astype(jnp.float32))
    got = _features(False, torch.bfloat16, seed, K).float().numpy()
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=BF16_TOL * scale)


def test_hybrid_merged_march_route(monkeypatch):
    """The hybrid's z-merged march: on a (faked) card a serving render
    takes K2 for it, after the points-only march (two launches), and a
    training render never does; on the CPU it is the plain march whatever
    the flag, as in JAX."""
    from test_torch_hybrid import _scene, hybrid_cfg
    cfg = hybrid_cfg()
    tp, tpc, tst, tgrid, tb, tcfg = _scene(cfg)[1]
    for flag in (True, False):
        c = tcfg.replace(render=dataclasses.replace(tcfg.render,
                                                    fused_march=flag))
        assert tr.merged_march_takes_kernel(c, CUDA, train=False)
        assert not tr.merged_march_takes_kernel(c, CUDA, train=True)
        assert not tr.merged_march_takes_kernel(c, CPU, train=False)
    calls = []
    real_march, real_pick = tr.fused_march, tr.march_takes_kernel

    def march(*a, **k):
        calls.append(a[0].shape)
        return real_march(*a, **k)
    monkeypatch.setattr(tr, "fused_march", march)
    with torch.no_grad():
        tr.render_rays(tp, tpc, tst, tgrid, tb, tcfg)
    assert len(calls) == 1                   # CPU: the flag's points march
    calls.clear()
    monkeypatch.setattr(tr, "march_takes_kernel",
                        lambda c, _d, train: real_pick(c, CUDA, train))
    monkeypatch.setattr(tr, "merged_march_takes_kernel",
                        lambda c, _d, train: real_pick(c, CUDA, train))
    with torch.no_grad():
        tr.render_rays(tp, tpc, tst, tgrid, tb, tcfg)
    SR, Ni = tcfg.query.SR, tcfg.render.nerf_importance
    assert [s[1] for s in calls] == [SR, SR + Ni]
    calls.clear()
    with torch.no_grad():
        tr.render_rays(tp, tpc, tst, tgrid, tb, tcfg, train=True,
                       generator=torch.Generator().manual_seed(0))
    assert calls == []


def test_feedforward_step_takes_the_f32_decode_kernels(monkeypatch):
    """The feed-forward step (ff_demo's config, f32) on a (faked) card: the
    decode goes to K3 and its backward to K4, on the CUDA-core (f32) route,
    once each a step; the march never to K2 (training takes the plain
    march); the loss is the CPU step's (the flags off: the unfused decode)
    within 2e-4."""
    from pointnerf_tpu_torch.mvs.points_init import (MvsPointsInit,
                                                     init_mvs_points)
    from pointnerf_tpu_torch.ops import fused_decode as fd
    from pointnerf_tpu_torch.train import driver as td
    from pointnerf_tpu_torch.train import feedforward as tff
    from test_torch_feedforward import CAPACITY, mvs_group
    cfg = td.ff_demo_config()
    assert not cfg.agg.fused_decode and cfg.train.compute_dtype == "f32"
    model = MvsPointsInit(point_features_dim=cfg.agg.point_features_dim)
    variables = init_mvs_points(model, torch.Generator().manual_seed(0))
    agg = ta.init_aggregator_params(cfg.agg, torch.Generator().manual_seed(1),
                                    device="cpu")
    images, Ks, w2cs, dv, target = mvs_group(0)
    batch = td._mvs_batch(images, Ks, w2cs, dv, tr.ray_batch_from_numpy(
        target, cfg, device="cpu"), CPU)
    u = torch.rand((batch.rays.raydir.shape[0], cfg.query.z_depth_dim),
                   generator=torch.Generator().manual_seed(3))
    step = tff.make_feedforward_step(cfg, model, CAPACITY)[0]

    def run():
        state = tff.create_ff_state(torch.Generator(), variables, agg, cfg)
        return step(state, batch, u=u)[1]["loss_total"]
    cpu_loss = run()
    specs = {"fused_decode": [], "fused_decode_bwd": [], "fused_march": 0}
    real_dec, real_bwd = ta.fused_decode, fd.fused_decode_bwd
    real_march = tr.fused_march

    def dec(*a, **k):
        specs["fused_decode"].append(a[5])
        return real_dec(*a, **k)

    def bwd(*a, **k):
        specs["fused_decode_bwd"].append(a[5])
        return real_bwd(*a, **k)

    def march(*a, **k):
        specs["fused_march"] += 1
        return real_march(*a, **k)
    real_pick_d, real_pick_m = ta.decode_takes_kernel, tr.march_takes_kernel
    monkeypatch.setattr(ta, "fused_decode", dec)
    monkeypatch.setattr(fd, "fused_decode_bwd", bwd)
    monkeypatch.setattr(tr, "fused_march", march)
    monkeypatch.setattr(ta, "decode_takes_kernel",
                        lambda c, _d: real_pick_d(c, CUDA))
    monkeypatch.setattr(tr, "march_takes_kernel",
                        lambda c, _d, train: real_pick_m(c, CUDA, train))
    card_loss = run()
    assert [s.bf16 for s in specs["fused_decode"]] == [False]
    assert [s.bf16 for s in specs["fused_decode_bwd"]] == [False]
    assert fd.route(specs["fused_decode"][0]) == "cuda_core"
    assert specs["fused_march"] == 0
    assert abs(float(card_loss) - float(cpu_loss)) <= 2e-4 * float(cpu_loss)
