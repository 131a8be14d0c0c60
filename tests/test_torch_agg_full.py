"""The whole aggregator (pointnerf_tpu_torch/models/aggregator.py) against the
JAX package's, with the same weights (convert.params_from_jax) and the same
numpy inputs from a seed:

- every distance kernel (quadric, numlinear, numquadric, avg, trilinear,
  sh_intrp in both activations and both distance functions, feat_intrp and
  its alias meta_intrp with the learned weight MLP, gau_intrp, linear with
  a non-uniform axis weight) with the fused decode on (JAX's Pallas kernel
  in interpret mode, the port's plain K3 / K4): the features, and the
  gradients of every parameter (feat_weight included) and of sp.features,
  within 2e-4 of scale;
- every layout outside the fused envelope (agg_intrp_order 0 and 1,
  block2 with and without the feat xyz hook, the alpha and color xyz hooks,
  a 2-layer alpha head, block3 absent) through JAX's XLA decode: in f32 the
  features and the parameter gradients within 2e-4, in bf16 the features
  within 2e-2 of scale (the bf16 bar of tests/test_torch_decode.py);
- one train_step each for feat_intrp and block2 (loss, Adam moments);
- a checkpoint round trip of a state with feat_weight and block2.

JAX's results are computed once per module (`jax_results`)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.config import tiny_test_config
from pointnerf_tpu.models.aggregator import aggregate as j_aggregate
from pointnerf_tpu.models.aggregator import init_aggregator_params
from pointnerf_tpu.models.points import SampledPoints as JSP
from pointnerf_tpu.train import step as js
from pointnerf_tpu_torch import config as tc
from pointnerf_tpu_torch.convert import params_from_jax, train_state_from_jax
from pointnerf_tpu_torch.models import aggregator as ta
from pointnerf_tpu_torch.models.points import SampledPoints as TSP
from pointnerf_tpu_torch.train import step as ts
from test_torch_render import interpret_pallas  # noqa: F401
from test_torch_train import (_assert_tree_close, _jax_u, _port_st, _scene,
                              _train_cfg)

F32_TOL = 2e-4
BF16_TOL = 2e-2
VSIZE = (2.0, 2.0, 2.0)   # trilinear's 1 - |d| / vsize[0] stays positive

KERNELS = {
    "quadric": dict(agg_distance_kernel="quadric"),
    "numlinear": dict(agg_distance_kernel="numlinear"),
    "numquadric": dict(agg_distance_kernel="numquadric"),
    "avg": dict(agg_distance_kernel="avg"),
    "trilinear": dict(agg_distance_kernel="trilinear"),
    "sh_intrp": dict(agg_distance_kernel="sh_intrp"),
    "sh_intrp_tanh_quadric": dict(agg_distance_kernel="sh_intrp",
                                  sh_act="tanh", sh_dist_func="sh_quadric"),
    "feat_intrp": dict(agg_distance_kernel="feat_intrp"),
    "meta_intrp": dict(agg_distance_kernel="meta_intrp"),
    "gau_intrp": dict(agg_distance_kernel="gau_intrp"),
    "linear_axis": dict(agg_axis_weight=(1.0, 2.0, 1.0)),
}
LAYOUTS = {
    "order0": dict(agg_intrp_order=0),
    "order1": dict(agg_intrp_order=1),
    "block2": dict(shading_feature_mlp_layer2=1),
    "block2_feat_xyz": dict(shading_feature_mlp_layer2=1,
                            agg_feat_xyz_mode="world"),
    "alpha_color_xyz": dict(agg_alpha_xyz_mode="world",
                            agg_color_xyz_mode="world"),
    "alpha2": dict(shading_alpha_mlp_layer=2),
    "no_block3": dict(shading_feature_mlp_layer3=0),
}


def _inputs(agg_kw, seed, fused, R=5, SR=4, K=4, Fi=24):
    cfg = tiny_test_config()
    cfg = cfg.replace(agg=dataclasses.replace(
        cfg.agg, point_features_dim=Fi, shading_feature_num=32,
        fused_decode=fused, **agg_kw))
    rng = np.random.RandomState(seed)
    mask = rng.rand(R, SR, K) > 0.3
    mask[:, 0] = True
    mask[0, 1] = False                    # a shading point without neighbors

    def f(*shape):
        return rng.normal(0, 0.3, shape).astype(np.float32)
    sp = dict(xyz=f(R, SR, K, 3), xyz_pers=f(R, SR, K, 3),
              features=f(R, SR, K, Fi),
              conf=rng.rand(R, SR, K, 1).astype(np.float32),
              color=f(R, SR, K, 3), dirs=f(R, SR, K, 3), mask=mask)
    rd = rng.normal(0, 1, (R, SR, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    cot = rng.normal(0, 1, (R, SR, 1 + cfg.agg.shading_color_channel_num)
                     ).astype(np.float32)
    params = jax.tree.map(np.asarray, init_aggregator_params(
        jax.random.PRNGKey(seed), cfg.agg))
    return cfg, params, sp, f(R, SR, 3), f(R, SR, 3), rd, cot


def _jax_run(case, dtype):
    cfg, params, sp, sl, slw, rd, cot = case

    def out(p, feats):
        s = JSP(**{k: jnp.asarray(v) for k, v in sp.items()
                   if k != "features"}, features=feats)
        return j_aggregate(p, cfg.agg, s, jnp.asarray(sl), jnp.asarray(slw),
                           jnp.asarray(rd), VSIZE, Rw2c=jnp.eye(3),
                           compute_dtype=dtype).features
    feats = jnp.asarray(sp["features"])
    if dtype == jnp.bfloat16:
        return np.asarray(jax.jit(out)(params, feats)), None

    def out_and_grads(p, x, c):           # one compile for both passes
        y, vjp = jax.vjp(out, p, x)
        return y, vjp(c)
    y, g = jax.jit(out_and_grads)(params, feats, jnp.asarray(cot))
    return np.asarray(y), jax.tree.map(np.asarray, g)


def _port_run(case, dtype):
    cfg, params, sp, sl, slw, rd, cot = case
    tcfg = tc.PointNeRFConfig.from_json(cfg.to_json())
    tp = params_from_jax(params, device="cpu")
    leaves = [t for layers in tp.values() for layer in layers
              for t in layer.values()]
    for t in leaves:
        t.requires_grad_()
    feats = torch.from_numpy(sp["features"]).requires_grad_()
    s = TSP(**{k: torch.from_numpy(v) for k, v in sp.items()
               if k != "features"}, features=feats)
    y = ta.aggregate(tp, tcfg.agg, s, torch.from_numpy(sl),
                     torch.from_numpy(slw), torch.from_numpy(rd), VSIZE,
                     Rw2c=torch.eye(3), compute_dtype=dtype).features
    if dtype == torch.bfloat16:
        return y.detach().numpy(), None
    g = torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                            leaves + [feats], allow_unused=True)
    g = [torch.zeros_like(t) if d is None else d
         for t, d in zip(leaves + [feats], g)]
    it = iter(g)
    gp = {k: [{n: next(it) for n in layer} for layer in layers]
          for k, layers in tp.items()}
    return y.detach().numpy(), (gp, next(it))


@pytest.fixture(scope="module")
def jax_results():
    """JAX's outputs and gradients per (setting, dtype), computed once."""
    cache = {}

    def get(name, table, fused, dtype):
        key = (name, fused, dtype)
        if key not in cache:
            case = _inputs(table[name], seed=3 + list(table).index(name),
                           fused=fused)
            cache[key] = (case, _jax_run(case, dtype))
        return cache[key]
    return get


def _assert_close(t, j, tol, what):
    scale = max(float(np.abs(j).max()), 1e-12)
    np.testing.assert_allclose(t, j, rtol=0, atol=tol * scale, err_msg=what)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_distance_kernel_matches_jax(name, jax_results, interpret_pallas):
    """The fused decode on both sides (JAX's Pallas kernel in interpret
    mode, the port's plain K3 / K4): features, parameter and feature
    gradients within 2e-4 of scale."""
    case, (yj, (gpj, gfj)) = jax_results(name, KERNELS, True, jnp.float32)
    assert ta.fused_decode_supported(
        tc.PointNeRFConfig.from_json(case[0].to_json()).agg)
    yt, (gpt, gft) = _port_run(case, torch.float32)
    _assert_close(yt, yj, F32_TOL, f"{name} features")
    _assert_tree_close(gpt, gpj, f"{name} param grads")
    _assert_close(gft.numpy(), gfj, F32_TOL, f"{name} feature grads")
    if name in ("feat_intrp", "meta_intrp"):
        assert "feat_weight" in gpt
        assert all(float(layer["w"].abs().max()) > 0
                   for layer in gpt["feat_weight"])


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layout_matches_jax_f32(name, jax_results):
    """JAX's XLA decode in f32: features and gradients within 2e-4."""
    case, (yj, (gpj, gfj)) = jax_results(name, LAYOUTS, False, jnp.float32)
    tcfg = tc.PointNeRFConfig.from_json(case[0].to_json())
    assert not ta.fused_envelope(tcfg.agg)
    assert not ta.decode_takes_kernel(tcfg.agg, torch.device("cuda"))
    yt, (gpt, gft) = _port_run(case, torch.float32)
    _assert_close(yt, yj, F32_TOL, f"{name} features")
    _assert_tree_close(gpt, gpj, f"{name} param grads")
    _assert_close(gft.numpy(), gfj, F32_TOL, f"{name} feature grads")


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layout_matches_jax_bf16(name, jax_results):
    """JAX's XLA decode in bf16 (each part of a virtual concat rounds its
    own product): features within 2e-2 of scale. The outputs themselves
    round to bf16, so a sum in another order moves an output by a bf16
    step (readings: 4e-3 to 7.4e-3 of scale; the port in f32 reads 5.2e-3
    to 1.1e-2, so no control separates at this size)."""
    case, (yj, _g) = jax_results(name, LAYOUTS, False, jnp.bfloat16)
    yt, _ = _port_run(case, torch.bfloat16)
    _assert_close(yt, yj, BF16_TOL, f"{name} bf16 features")


def _step_cfg(**agg_kw):
    cfg = _train_cfg(fused=False)
    return cfg.replace(agg=dataclasses.replace(
        cfg.agg, point_features_dim=16, **agg_kw))


@pytest.mark.parametrize("agg_kw", [dict(agg_distance_kernel="feat_intrp"),
                                    dict(shading_feature_mlp_layer2=1)],
                         ids=["feat_intrp", "block2"])
def test_train_step_matches_jax(agg_kw):
    """One train step from a fresh state: the loss, the step and every Adam
    moment within 2e-4, feat_weight's and block2's included."""
    cfg = _step_cfg(**agg_kw)
    pc, st, params, grid, jb, tcfg, tb, tgrid = _scene(cfg)
    jstate = js.create_train_state(jax.random.PRNGKey(7), params, pc, cfg)
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                  torch.Generator(), device="cpu")
    name = "feat_weight" if "agg_distance_kernel" in agg_kw else "block2"
    assert name in tstate.params["mlp"] and name in tstate.opt_state[
        "mlp"].mu
    u = _jax_u(jstate.key, cfg, 64)
    jnew, jout = js.train_step(jstate, st, grid, jb, cfg)
    tnew, tout = ts.train_step(tstate, _port_st(st), tgrid, tb, tcfg,
                               u=torch.from_numpy(u))
    np.testing.assert_allclose(tout["loss_total"].numpy(),
                               np.asarray(jout["loss_total"]), rtol=F32_TOL)
    assert int(tnew.step) == int(jnew.step) == 1
    inner = jnew.opt_state.inner_states["mlp"].inner_state[0]
    _assert_tree_close(tnew.opt_state["mlp"].mu, inner.mu["mlp"], "mlp mu")
    _assert_tree_close(tnew.opt_state["mlp"].nu, inner.nu["mlp"], "mlp nu")
    assert float(tnew.opt_state["mlp"].nu[name][0]["w"].abs().max()) > 0


def test_checkpoint_round_trip_with_new_params(tmp_path):
    """save_checkpoint / load_checkpoint carry feat_weight and block2 (the
    parameters and their Adam moments) bit for bit."""
    from pointnerf_tpu_torch.models.points import make_point_cloud
    from pointnerf_tpu_torch.train.checkpoint import (load_checkpoint,
                                                      save_checkpoint)
    from pointnerf_tpu_torch.train.optim import tree_leaves, tree_map
    cfg = tc.tiny_test_config()
    cfg = cfg.replace(agg=dataclasses.replace(
        cfg.agg, agg_distance_kernel="meta_intrp", point_features_dim=16,
        shading_feature_mlp_layer2=2))
    g = torch.Generator().manual_seed(0)
    params = ta.init_aggregator_params(cfg.agg, g, device="cpu")
    assert {"feat_weight", "block2"} <= set(params)
    assert [tuple(layer["w"].shape) for layer in params["feat_weight"]] == [
        (20, 10), (10, 10), (10, 1)]
    xyz = np.random.RandomState(0).rand(50, 3).astype(np.float32)
    pc, _st = make_point_cloud(xyz, g, cfg.points,
                               cfg.agg.point_features_dim, device="cpu")
    state = ts.create_train_state(torch.Generator(), params, pc, cfg)
    noisy = tree_map(lambda t: t + torch.rand(t.shape, generator=g)
                     if t.is_floating_point() else t, state.opt_state)
    state = state._replace(opt_state=noisy)
    path = save_checkpoint(str(tmp_path), state)
    fresh = ts.create_train_state(
        torch.Generator(), ta.init_aggregator_params(
            cfg.agg, torch.Generator().manual_seed(5), device="cpu"),
        pc, cfg)
    back, _meta = load_checkpoint(path, fresh)
    for a, b in zip(tree_leaves(back.params["mlp"]),
                    tree_leaves(state.params["mlp"])):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(back.opt_state["mlp"]),
                    tree_leaves(state.opt_state["mlp"])):
        assert torch.equal(a, b)
    assert torch.equal(back.params["mlp"]["feat_weight"][1]["w"],
                       params["feat_weight"][1]["w"])


def test_reference_scene_carries_feat_weight_and_block2():
    """The reference names `aggregator.feat_weight_mlp` and
    `aggregator.block2` map to `feat_weight` and `block2`: an exported
    scene imports back with both, bit for bit, and a scene without them
    is refused as an architecture mismatch."""
    from pointnerf_tpu_torch.models.points import make_point_cloud
    from pointnerf_tpu_torch.train.torch_import import (
        export_reference_scene, import_reference_scene)
    cfg = tc.tiny_test_config()
    cfg = cfg.replace(agg=dataclasses.replace(
        cfg.agg, agg_distance_kernel="feat_intrp", point_features_dim=16,
        shading_feature_mlp_layer2=1))
    g = torch.Generator().manual_seed(3)
    params = ta.init_aggregator_params(cfg.agg, g, device="cpu")
    xyz = np.random.RandomState(1).rand(40, 3).astype(np.float32)
    pc, st = make_point_cloud(xyz, g, cfg.points, 16, device="cpu")
    sd = export_reference_scene(pc, st, params)
    assert "aggregator.feat_weight_mlp.4.weight" in sd
    assert "aggregator.block2.0.weight" in sd
    _pc, _st, back = import_reference_scene(sd, cfg, device="cpu")
    for name in ("feat_weight", "block2"):
        for a, b in zip(back[name], params[name]):
            assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    plain = {k: v for k, v in sd.items()
             if not k.startswith("aggregator.feat_weight_mlp")}
    with pytest.raises(ValueError, match="architecture mismatch"):
        import_reference_scene(plain, cfg, device="cpu")
