"""The port's feed-forward step (pointnerf_tpu_torch/train/feedforward.py)
against JAX's `make_feedforward_step`, at `ff_demo`'s configuration on
32 x 32 views (tests/test_feedforward.py's batch: three ring views of the
sphere, 64 target rays, 16 depth planes), and the `ff_demo` / `--ff-demo`
entry points on the CPU.

Both steps start from the same state: JAX's MvsPointsInit variables (a
seeded fill of flax's tree, tests/test_torch_mvs.py) and aggregator init,
carried across by `convert`; the port takes JAX's jitter draw. Bars: the
eval-mode cloud and the gradient through it into every MVS weight within
2e-4 of scale; the step's loss within 2e-4, and its gradients, Adam
moments, parameters and BatchNorm running stats within 2e-4 plus twice
JAX's own f32 distance from its float64 step (train-mode BatchNorm on
these small tensors makes MVSNet's gradients f32 rounding:
test_one_step_matches_jax); a 4-step loss curve (alter_step 3) within 1e-3
relative; `infer_cloud`'s num_active equal and its points within 2e-4.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.config import (AggregatorConfig, PointNeRFConfig,
                                  QueryConfig, RenderConfig, TrainConfig)
from pointnerf_tpu.data.synthetic import ring_cameras, view_ray_batch
from pointnerf_tpu.models.aggregator import init_aggregator_params
from pointnerf_tpu.models.renderer import RayBatch
from pointnerf_tpu.mvs.points_init import view_proj_mats
from pointnerf_tpu.train.feedforward import (MVSBatch, create_ff_state,
                                             make_feedforward_step)
from pointnerf_tpu_torch import config as tcfg
from pointnerf_tpu_torch.convert import mvs_variables_from_jax, params_from_jax
from pointnerf_tpu_torch.models.renderer import ray_batch_from_numpy
from pointnerf_tpu_torch.mvs import points_init as tpi
from pointnerf_tpu_torch.mvs.mvsnet import mvs_precision as tmvs_precision
from pointnerf_tpu_torch.train import driver as td
from pointnerf_tpu_torch.train import feedforward as tff
from test_torch_mvs import jax_mvs_variables

TOL = 2e-4
CURVE_BAR = 1e-3
F64_FACTOR = 2.0
WH = (32, 32)
CAPACITY = 128
N_RAYS = 64


def ff_cfg():
    """tests/test_feedforward.py's config (ff_demo's)."""
    return PointNeRFConfig(
        query=QueryConfig(vsize=(0.1, 0.1, 0.1), vscale=(2.0, 2.0, 2.0),
                          max_o=2048, P=8, K=4, SR=12, z_depth_dim=48,
                          ranges=(-2.0, -2.0, -2.0, 2.0, 2.0, 2.0),
                          knn_chunk=4096),
        agg=AggregatorConfig(point_features_dim=8, shading_feature_num=32,
                             num_feat_freqs=2, dist_xyz_freq=3,
                             num_pos_freqs=4, num_viewdir_freqs=2),
        render=RenderConfig(near_plane=2.0, far_plane=4.5),
        train=TrainConfig(random_sample_size=8))


def mvs_group(seed=0):
    """Three ring views of the sphere and a fourth view's rays (numpy)."""
    V = 3
    views = ring_cameras(n_views=V + 1, wh=WH, focal=float(WH[0]))
    images, Ks, w2cs = [], [], []
    for campos, rot, K in views[:V]:
        item = view_ray_batch(campos, rot, K, WH)
        images.append(item["gt_image"].reshape(WH[1], WH[0], 3))
        Ks.append(K)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = rot.T
        w2c[:3, 3] = -rot.T @ campos
        w2cs.append(w2c)
    target = view_ray_batch(*views[V], WH, n_rays=N_RAYS, seed=seed)
    return (np.stack(images), np.stack(Ks), np.stack(w2cs),
            np.linspace(2.0, 4.5, 16).astype(np.float32), target)


def jax_batch(cfg, group):
    images, Ks, w2cs, dv, t = group
    rays = RayBatch(
        campos=jnp.asarray(t["campos"]), camrotc2w=jnp.asarray(
            t["camrotc2w"]), raydir=jnp.asarray(t["raydir"]),
        pixel_idx=jnp.asarray(t["pixel_idx"], jnp.int32),
        near=jnp.asarray(cfg.render.near_plane),
        far=jnp.asarray(cfg.render.far_plane),
        gt_image=jnp.asarray(t["gt_image"]))
    return MVSBatch(images=jnp.asarray(images),
                    proj_mats=jnp.asarray(view_proj_mats(Ks, w2cs, 0)),
                    Ks=jnp.asarray(Ks), w2cs=jnp.asarray(w2cs),
                    depth_values=jnp.asarray(dv), rays=rays)


def port_batch(pcfg, group):
    images, Ks, w2cs, dv, t = group
    return td._mvs_batch(images, Ks, w2cs, dv,
                         ray_batch_from_numpy(t, pcfg, device="cpu"),
                         torch.device("cpu"))


def jax_u(key, cfg):
    """The jitter of JAX's step at this state key: split, split, uniform."""
    _key, sub = jax.random.split(key)
    k_coarse, _k_fine = jax.random.split(sub)
    return torch.tensor(np.asarray(jax.random.uniform(
        k_coarse, (N_RAYS, cfg.query.z_depth_dim), dtype=jnp.float32)))


def rel(a, b, floor=1e-12):
    """max |a - b| / max(max |b|, floor)."""
    a = a.detach().double().numpy() if torch.is_tensor(a) else np.asarray(
        a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), floor))


def port_mvs_tree(tree):
    """A flax-layout params tree (numpy) -> the port's flat names."""
    return mvs_variables_from_jax({"params": tree}, device="cpu")["params"]


def assert_mlp_close(t_tree, j_tree, what, tol=TOL):
    tl = jax.tree.leaves(t_tree, is_leaf=torch.is_tensor)
    jl = jax.tree.leaves(jax.tree.map(np.asarray, j_tree))
    assert len(tl) == len(jl) > 0
    for i, (a, b) in enumerate(zip(tl, jl)):
        assert rel(a, b) <= tol, f"{what} leaf {i}: {rel(a, b)}"


def assert_mvs_close(t_flat, j_tree, what, tol=TOL):
    ref = port_mvs_tree(jax.tree.map(np.asarray, j_tree))
    assert sorted(t_flat) == sorted(ref)
    for k, v in ref.items():
        assert rel(t_flat[k], v.numpy()) <= tol, f"{what} {k}"


def start_model():
    from pointnerf_tpu.mvs.points_init import MvsPointsInit
    return MvsPointsInit(point_features_dim=8)


def jax_variables():
    return jax_mvs_variables(V=3, H=WH[1], W=WH[0], D=16)[1]


@pytest.fixture(scope="module")
def start():
    """The JAX state at step 0 (numpy leaves), its step and infer_cloud,
    and the port's state and model from the same numbers."""
    cfg = ff_cfg()
    model, variables = start_model(), jax_variables()
    agg = init_aggregator_params(jax.random.PRNGKey(1), cfg.agg)
    jstate = create_ff_state(jax.random.PRNGKey(2), variables, agg, cfg)
    jstep, jinfer = make_feedforward_step(cfg, model, capacity=CAPACITY)
    pcfg = tcfg.PointNeRFConfig.from_json(cfg.to_json())
    tmodel = tpi.MvsPointsInit(point_features_dim=8)

    def port_state():
        tv = mvs_variables_from_jax(variables, device="cpu")
        return tff.create_ff_state(
            torch.Generator().manual_seed(0), tv,
            params_from_jax(jax.tree.map(np.asarray, agg), device="cpu"),
            pcfg)
    return cfg, pcfg, jstate, jstep, jinfer, tmodel, port_state


def _f64(tree):
    """float32 leaves -> float64 (inside jax.enable_x64)."""
    def up(a):
        a = np.asarray(a)
        return jnp.asarray(a.astype(np.float64) if a.dtype == np.float32
                           else a)
    return jax.tree.map(up, tree)


def _flat(tree):
    """{name: float64 array} of a port tree (flat mvs dict or mlp tree)."""
    if isinstance(tree, dict) and all(torch.is_tensor(v) for v in
                                      tree.values()):
        return {k: v.detach().double().numpy() for k, v in tree.items()}
    return {str(i): a.detach().double().numpy()
            for i, a in enumerate(jax.tree.leaves(tree,
                                                  is_leaf=torch.is_tensor))}


def _jflat(tree, mvs):
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    if mvs:
        return {k: v.double().numpy() for k, v in port_mvs_tree(tree).items()}
    return {str(i): np.asarray(a, np.float64)
            for i, a in enumerate(jax.tree.leaves(tree))}


def test_gen_cloud_and_its_gradient_match_jax(start):
    """The eval-mode cloud (infer_cloud's) and the gradient of a random
    linear function of it with respect to every MVS parameter: through
    MVSNet (warp, cost volume, 3D UNet, softmax, regression), the lifting
    and the embedding. Eval-mode BatchNorm is well conditioned, so every
    tensor is held within 2e-4 of its scale."""
    cfg, pcfg, jstate, _jstep, jinfer, tmodel, port_state = start
    group = mvs_group(0)
    jb = jax_batch(cfg, group)
    stats = jax.tree.map(jnp.asarray, jstate.mvs_stats)
    fields = ("xyz", "features", "color", "dirs")
    jpc, jvjp = jax.vjp(lambda p: jinfer({"mvs": p}, stats, jb)[0],
                        jstate.params["mvs"])
    rng = np.random.RandomState(3)
    cts = {f: rng.randn(*np.shape(getattr(jpc, f))).astype(np.float32)
           for f in jpc._fields}
    for f in jpc._fields:
        if f not in fields:
            cts[f] = np.zeros_like(cts[f])
    n = (WH[0] // 4) * (WH[1] // 4)
    for f in fields:
        cts[f][n:] = 0.0            # the padding carries no gradient
    (jg,) = jvjp(type(jpc)(**{f: jnp.asarray(v) for f, v in cts.items()}))
    ts = port_state()
    params = {k: v.detach().requires_grad_() for k, v in
              ts.params["mvs"].items()}
    with torch.enable_grad(), tmvs_precision():
        tpc, tst, _ = tff.gen_cloud(tmodel, CAPACITY, params, ts.mvs_stats,
                                    port_batch(pcfg, group), train=False)
        obj = sum((getattr(tpc, f) * torch.tensor(cts[f])).sum()
                  for f in fields)
        tg = torch.autograd.grad(obj, list(params.values()))
    assert int(tst.num_active) == n
    for f in fields:
        assert rel(getattr(tpc, f)[:n], np.asarray(getattr(jpc, f))[:n]) \
            <= TOL, f
    ref = _jflat(jg, True)
    got = dict(zip(params, [g.double().numpy() for g in tg]))
    assert sorted(got) == sorted(ref)
    # the prob conv's bias gets an exact zero (softmax over depth ignores a
    # shift): its scale floors at 1e-3 of the largest gradient's
    floor = 1e-3 * max(np.abs(v).max() for v in ref.values())
    for k in ref:
        err = np.abs(got[k] - ref[k]).max() / max(np.abs(ref[k]).max(), floor)
        assert err <= TOL, (k, err)


def test_one_step_matches_jax(start):
    """One train-mode step. Train-mode BatchNorm over the small tensors of
    these views (CostRegNet's deepest layers see 2 values a channel, and
    the sphere's flat background gives near-constant channels) divides
    f32 roundings by sqrt(eps): JAX's own f32 step lies a median 4.9e-3 of
    scale from its float64 step (the same step under jax.enable_x64), and
    ~100% on MVSNet's deepest gradients. So the loss is held within 2e-4,
    and every gradient, moment, parameter and running stat within 2e-4
    plus twice JAX's own f32 distance from float64 (as chip_smoke's
    hold_max holds K4 bf16), and within 2e-4 plus that distance of the
    float64 step itself."""
    cfg, pcfg, jstate, jstep, _jinfer, tmodel, port_state = start
    group = mvs_group(0)
    u = jax_u(jstate.key, cfg)
    j0 = jax.tree.map(lambda a: np.array(a), jstate)
    jnew, jitems = jstep(jax.tree.map(jnp.asarray, j0),
                         jax_batch(cfg, group))
    with jax.enable_x64():
        j64, _ = jstep(_f64(j0), _f64(jax_batch(cfg, group)))
        j64 = jax.tree.map(np.asarray, j64)
    tstate = port_state()
    tbatch = port_batch(pcfg, group)
    total, _items, grads, new_stats = tff.ff_loss_and_grads(
        pcfg, tmodel, CAPACITY, tstate.params, tstate.mvs_stats, tbatch,
        u=u)
    assert rel(total, jitems["loss_total"]) <= TOL
    tnew, titems = tff.make_feedforward_step(pcfg, tmodel, CAPACITY)[0](
        tstate, tbatch, u=u)
    assert rel(titems["loss_total"], jitems["loss_total"]) <= TOL
    assert rel(titems["psnr"], jitems["psnr"]) <= TOL
    # gradient reached MVSNet's convolutions through xyz and the payloads
    for k in ("mvsnet.cost_regularization.conv0.conv.weight",
              "mvsnet.feature.conv0.conv.weight", "premlp.0.weight"):
        assert float(grads["mvs"][k].abs().max()) > 0, k

    def adam(state, g):
        return state.opt_state.inner_states[g].inner_state[0]
    readings, to64 = [], []
    for g in ("mlp", "mvs"):
        mvs = g == "mvs"
        ja, a64 = adam(jnew, g), adam(j64, g)
        assert int(tnew.opt_state[g].count) == int(ja.count) == 1
        pairs = {
            "gradient": (_flat(grads[g]), _jflat(ja.mu[g], mvs),
                         _jflat(a64.mu[g], mvs), 0.1),
            "mu": (_flat(tnew.opt_state[g].mu), _jflat(ja.mu[g], mvs),
                   _jflat(a64.mu[g], mvs), 1.0),
            "nu": (_flat(tnew.opt_state[g].nu), _jflat(ja.nu[g], mvs),
                   _jflat(a64.nu[g], mvs), 1.0),
            "params": (_flat(tnew.params[g]), _jflat(jnew.params[g], mvs),
                       _jflat(j64.params[g], mvs), 1.0)}
        for what, (t, j, c, scale) in pairs.items():
            assert sorted(t) == sorted(j)
            # a tensor of exact zeros (the prob conv's bias: softmax over
            # depth ignores a shift) is read on 1e-3 of the group's scale
            fl = 1e-3 * max(np.abs(v).max() for v in j.values()) / scale
            for k in j:
                readings.append((f"{g} {what} {k}",
                                 rel(t[k], j[k] / scale, fl),
                                 rel(c[k], j[k], fl * scale)))
                to64.append((rel(t[k], c[k] / scale, fl),
                             rel(j[k], c[k], fl * scale)))
    jst = _jflat(jnew.mvs_stats, False)
    cst = _jflat(j64.mvs_stats, False)
    tst = mvs_variables_from_jax({"params": {}, "batch_stats": jax.tree.map(
        np.asarray, jnew.mvs_stats)}, device="cpu")["batch_stats"]
    assert sorted(tst) == sorted(tnew.mvs_stats) and len(jst) == len(tst)
    for k, v in tst.items():
        assert torch.equal(tnew.mvs_stats[k], new_stats[k])
        readings.append((f"stats {k}", rel(tnew.mvs_stats[k], v.numpy()),
                         0.0))
    for (k, a), b in zip(jst.items(), cst.values()):
        readings[-len(jst) + int(k)] = readings[-len(jst) + int(k)][:2] + (
            rel(b, a),)
    bad = [r for r in readings if r[1] > TOL + F64_FACTOR * r[2]]
    assert not bad, bad[:10]
    # and no further from JAX's float64 step than JAX's f32 step is (the
    # port's CPU reductions sum more exactly: it is the closer of the two
    # on almost every tensor)
    far = [(r[0], d) for r, d in zip(readings, to64) if d[0] > d[1] + TOL]
    assert not far, far[:10]
    d = np.array(to64)
    assert (d[:, 0] <= d[:, 1]).mean() > 0.9
    # the old state is left as it was
    for k, v in port_state().params["mvs"].items():
        assert torch.equal(tstate.params["mvs"][k], v)
    assert int(tnew.step) == 1


def test_loss_curve_and_infer_cloud_match_jax(start):
    """4 steps with alter_step 3: three of the MLP group, then one of the
    MVS group (its loss read before its update), then a zero-shot cloud.
    With alter_step 0 no f32 curve is reproducible past one step: Adam's
    first step moves every weight by about lr whatever its gradient's size,
    and MVSNet's deepest gradients are f32 rounding (test_one_step): JAX's
    own f32 and float64 curves part by 23% at step 2."""
    cfg, pcfg, jstate, _jstep, jinfer, tmodel, port_state = start
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, alter_step=3))
    pcfg = tcfg.PointNeRFConfig.from_json(cfg.to_json())
    jstep, _ = make_feedforward_step(cfg, start_model(), capacity=CAPACITY)
    js = jax.tree.map(lambda a: jnp.asarray(np.array(a)), jstate)
    ts = port_state()
    tstep, tinfer = tff.make_feedforward_step(pcfg, tmodel, CAPACITY)
    jl, tl = [], []
    for i in range(4):
        if i == 3:
            # the zero-shot cloud after the MLP phase (MVSNet's weights as
            # they started, its running stats after three steps)
            group = mvs_group(99)
            jpc, jst = jinfer(js.params, js.mvs_stats, jax_batch(cfg, group))
            tpc, tst = tinfer(ts.params, ts.mvs_stats,
                              port_batch(pcfg, group))
        group = mvs_group(i)
        u = jax_u(js.key, cfg)
        js, ji = jstep(js, jax_batch(cfg, group))
        ts, ti = tstep(ts, port_batch(pcfg, group), u=u)
        jl.append(float(ji["loss_total"]))
        tl.append(float(ti["loss_total"]))
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=CURVE_BAR)
    for g, n in (("mlp", 3), ("mvs", 1)):
        assert int(ts.opt_state[g].count) == n == int(
            js.opt_state.inner_states[g].inner_state[0].count)
    n = int(jst.num_active)
    assert int(tst.num_active) == n == (WH[0] // 4) * (WH[1] // 4)
    assert rel(tpc.xyz[:n], np.asarray(jpc.xyz)[:n]) <= TOL
    assert (tpc.xyz[n:] == 1.0e8).all()
    assert rel(tpc.features[:n], np.asarray(jpc.features)[:n]) <= TOL
    assert not tpc.xyz.requires_grad


def test_ff_demo_and_cli_run_on_the_cpu(monkeypatch, capsys):
    state = td.ff_demo(steps=2, device="cpu")
    assert int(state.step) == 2
    assert all(torch.isfinite(v).all() for v in state.params["mvs"].values())
    monkeypatch.setattr(sys, "argv", ["driver", "--ff-demo", "--steps", "1",
                                      "--device", "cpu"])
    td.main()
    out = capsys.readouterr().out
    assert out.count("[ff] step 0: loss=") == 2
