"""The query of the reference ScanNet scenes on prebuilt tables, where K1's
rows are wider than 512 candidates: scene241's P = 26 (QP = 27 x 26 =
702), SR = 24 and K = 8 with prebuild_neighbors, no shell cut and
knn_select="pallas" (the JAX package's production query), the other widths
narrowed to tiny_test_config()'s and a small dense cloud, so that rows
hold live candidates past the 512th. Against JAX's (the Pallas kernels in
interpret mode): the tables, query_points, one request and one train
step's gradients — integers equal, floats within 2e-4 (the march 1e-5).
The card's rule on a faked CUDA device: such a query is not refused, and
K1 takes its wide path."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.config import tiny_test_config
from pointnerf_tpu.models.aggregator import init_aggregator_params
from pointnerf_tpu.models.points import make_point_cloud
from pointnerf_tpu.models.renderer import RayBatch
from pointnerf_tpu.ops import query as jq
from pointnerf_tpu.train import step as js
from pointnerf_tpu_torch import config as tc
from pointnerf_tpu_torch.convert import params_from_jax, train_state_from_jax
from pointnerf_tpu_torch.models import renderer as tr
from pointnerf_tpu_torch.ops import knn_select as tk
from pointnerf_tpu_torch.ops import query as tq
from pointnerf_tpu_torch.train import step as ts
from test_torch_render import (FLOATS, INTS, interpret_pallas,  # noqa: F401
                               make_batch)
from test_torch_train import (TOL, _assert_tree_close, _jax_u, _np,
                              _port_cloud, _port_st)

P, SR, K = 26, 24, 8               # scene241's widths
QP = 27 * P
MARCH = ("coarse_raycolor", "coarse_point_opacity", "coarse_is_background")
CUDA = torch.device("cuda")


def _cfg():
    cfg = tiny_test_config()
    return cfg.replace(
        query=dataclasses.replace(cfg.query, P=P, SR=SR, K=K,
                                  prebuild_neighbors=True,
                                  shell_layered=False, knn_select="pallas",
                                  decode_capacity=0.5),
        agg=dataclasses.replace(cfg.agg, fused_decode=True),
        render=dataclasses.replace(cfg.render, fused_march=True))


@pytest.fixture(scope="module")
def scene():
    """A 3,000-point cloud packed near the origin (tens of points a 0.08
    voxel), its JAX grid and the port's, the weights, one batch of 64
    rays with a target."""
    cfg = _cfg()
    rng = np.random.RandomState(0)
    xyz = np.clip(rng.normal(0, 0.12, (3000, 3)), -0.9, 0.9).astype(
        np.float32)
    campos = np.array([0.0, 0.0, -3.0], np.float32)
    camrot = np.eye(3, dtype=np.float32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    pc, st = make_point_cloud(xyz, k1, cfg.points, cfg.agg.point_features_dim,
                              capacity=4096)
    params = init_aggregator_params(k2, cfg.agg)
    grid = js.refresh_grid(pc, st, cfg)
    item = make_batch(campos, camrot, R=64, seed=1)
    item["gt_image"] = rng.rand(64, 3).astype(np.float32)
    jb = RayBatch(campos=jnp.asarray(campos), camrotc2w=jnp.asarray(camrot),
                  raydir=jnp.asarray(item["raydir"]),
                  pixel_idx=jnp.asarray(item["pixel_idx"]),
                  near=jnp.asarray(2.0), far=jnp.asarray(4.5),
                  gt_image=jnp.asarray(item["gt_image"]))
    tcfg = tc.PointNeRFConfig.from_json(cfg.to_json())
    tpc, tst = _port_cloud(pc, st)
    tgrid, _ = ts.refresh_grid(tpc, tst, tcfg)
    tb = tr.ray_batch_from_numpy(item, tcfg, device="cpu")
    return dict(cfg=cfg, xyz=xyz, pc=pc, st=st, params=params, grid=grid,
                jb=jb, tcfg=tcfg, tpc=tpc, tst=tst, tgrid=tgrid, tb=tb,
                campos=campos, raydir=item["raydir"])


def _k1_calls(monkeypatch):
    """Record the QP and K of every K1 call of the port's query."""
    seen, real = [], tq.knn_select

    def rec(nbr_xyz, nbr_pid, *a, K, r2):
        seen.append((nbr_pid.shape[1], K))
        return real(nbr_xyz, nbr_pid, *a, K=K, r2=r2)
    monkeypatch.setattr(tq, "knn_select", rec)
    return seen


def test_tables_hold_candidates_past_512(scene):
    """Rows of 702 candidates, some live past the 512th (the wide path's
    second chunk), as JAX's tables hold them."""
    g, tg = scene["grid"], scene["tgrid"]
    assert tuple(tg.nbr_pid.shape)[1] == QP
    live = tg.nbr_xyz[:, :QP] < tk.DEAD
    assert int(live[:, 512:].sum()) > 0 and int(live.sum(1).max()) > 300
    n = int(tg.num_dil)
    np.testing.assert_array_equal(tg.nbr_pid[:n].numpy(),
                                  np.asarray(g.nbr_pid)[:n])
    np.testing.assert_array_equal(tg.nbr_xyz[:n].numpy(),
                                  np.asarray(g.nbr_xyz)[:n])


def test_query_points_matches_jax(scene, interpret_pallas, monkeypatch):
    seen = _k1_calls(monkeypatch)
    cfg = scene["cfg"]
    qj = jq.query_points(jnp.asarray(scene["xyz"]), scene["grid"],
                         jnp.asarray(scene["campos"]),
                         jnp.asarray(scene["raydir"]), 2.0, 4.5, cfg.query)
    qt = tq.query_points(torch.from_numpy(scene["xyz"]), scene["tgrid"],
                         torch.from_numpy(scene["campos"]),
                         torch.from_numpy(scene["raydir"]), 2.0, 4.5,
                         scene["tcfg"].query)
    for f in ("sample_pidx", "sample_mask", "ray_mask", "sample_loc_w"):
        np.testing.assert_array_equal(getattr(qt, f).numpy(),
                                      np.asarray(getattr(qj, f)), err_msg=f)
    assert seen == [(QP, K)]
    assert int((qt.sample_pidx >= 0).sum()) > 500


def test_request_matches_jax(scene, interpret_pallas, monkeypatch):
    seen = _k1_calls(monkeypatch)
    oj = js.eval_step({"mlp": scene["params"], "points": scene["pc"]},
                      scene["st"], scene["grid"], scene["jb"], scene["cfg"])
    tp = params_from_jax(jax.tree.map(np.asarray, scene["params"]),
                         device="cpu")
    ot = ts.eval_step({"mlp": tp, "points": scene["tpc"]}, scene["tst"],
                      scene["tgrid"], scene["tb"], scene["tcfg"])
    assert seen == [(QP, K)]
    for f in INTS:
        np.testing.assert_array_equal(getattr(ot, f).numpy(),
                                      np.asarray(getattr(oj, f)), err_msg=f)
    for f in FLOATS:
        tol = 1e-5 if f in MARCH else TOL
        np.testing.assert_allclose(getattr(ot, f).numpy(),
                                   np.asarray(getattr(oj, f)), rtol=tol,
                                   atol=tol, err_msg=f)
    assert bool(ot.ray_mask.any()) and int(ot.decode_dropped) == 0


def test_train_step_matches_jax(scene, interpret_pallas):
    """The gradients of one jittered step (JAX's draw): the loss and every
    gradient of the aggregator and of the points' payloads."""
    cfg, st, grid, jb = scene["cfg"], scene["st"], scene["grid"], scene["jb"]
    state = js.create_train_state(jax.random.PRNGKey(7), scene["params"],
                                  scene["pc"], cfg)
    tstate = train_state_from_jax(_np(state), torch.Generator(), device="cpu")
    u = torch.from_numpy(_jax_u(state.key, cfg, 64).copy())
    _key, sub = jax.random.split(state.key)
    (jtot, _ji), jgrads = jax.jit(lambda p, k: jax.value_and_grad(
        js.loss_fn, has_aux=True)(p, st, grid, jb, cfg, k))(state.params, sub)
    ttot, _ti, tgrads = ts.loss_and_grads(tstate.params, _port_st(st),
                                          scene["tgrid"], scene["tb"],
                                          scene["tcfg"], u=u)
    np.testing.assert_allclose(ttot.numpy(), np.asarray(jtot), rtol=TOL)
    _assert_tree_close(tgrads["mlp"], jgrads["mlp"], "mlp grads")
    for f in ("features", "conf", "color", "dirs"):
        _assert_tree_close(getattr(tgrads["points"], f),
                           getattr(jgrads["points"], f), f"{f} grads")


def test_card_rule_takes_k1_past_qp_512():
    """On a faked card the query is not refused (check_envelope), K1 takes
    its wide path at QP = 702, 810, 864 and 1,080 for any K, its run and
    warp paths up to 512."""
    cfg = tc.PointNeRFConfig.from_json(_cfg().to_json())
    tr.check_envelope(cfg, CUDA)
    tr.check_envelope(cfg, CUDA, train=True)
    for p in (26, 30, 32, 40):
        c = cfg.replace(query=dataclasses.replace(cfg.query, P=p))
        tr.check_envelope(c, CUDA)
        for k in (1, 8, 16, 17, 24):
            assert tk.path_for(k, 27 * p) == "wide"
    assert tk.path_for(8, 512) == "runs" and tk.path_for(17, 512) == "warp"
    with pytest.raises(ValueError, match="0 < K <= QP"):
        tk.knn_select(torch.zeros((2, 30)),
                      torch.zeros((2, 10), dtype=torch.int32),
                      torch.zeros(1, dtype=torch.int32), torch.zeros((1, 3)),
                      torch.ones(1, dtype=torch.bool), K=11, r2=0.0)
