"""The port's point maintenance primitives (pointnerf_tpu_torch/models/points
prune and grow) and the dense neighbor query (ops/query.query_points)
against the JAX package's, on the same numpy clouds.

prune/grow move values without arithmetic, so every output must be equal:
the pack order, the kept and added counts and every packed array. The
query's integers (neighbor ids, masks) must be equal and its locations
within 1e-6 (the port's float64-rounded sample positions, ROADMAP Queue
3)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.models import points as jp
from pointnerf_tpu.ops.query import query_points as j_query_points
from pointnerf_tpu_torch.convert import point_cloud_from_numpy
from pointnerf_tpu_torch.models import points as tp
from pointnerf_tpu_torch.ops.query import query_points
from test_torch_render import _cfg, interpret_pallas, make_batch, setup  # noqa: F401


def _cloud(n=300, cap=512, seed=0):
    rng = np.random.RandomState(seed)
    xyz = np.full((cap, 3), jp.DEAD_XYZ, np.float32)
    xyz[:n] = rng.uniform(-0.5, 0.5, (n, 3))
    arrs = [xyz]
    for w in (8, 1, 3, 3):
        a = np.zeros((cap, w), np.float32)
        a[:n] = rng.rand(n, w)
        arrs.append(a)
    jpc = jp.PointCloud(*[jnp.asarray(a) for a in arrs])
    jst = jp.PointCloudStatic(num_active=jnp.asarray(n, jnp.int32),
                              Rw2c=jnp.eye(3))
    tpc, tst = point_cloud_from_numpy(*arrs, num_active=n, device="cpu")
    return jpc, jst, tpc, tst


def _equal(tpc, jpc):
    for f in jpc._fields:
        np.testing.assert_array_equal(getattr(tpc, f).numpy(),
                                      np.asarray(getattr(jpc, f)), err_msg=f)


@pytest.mark.parametrize("with_protect", [False, True])
def test_prune_matches_jax(with_protect):
    jpc, jst, tpc, tst = _cloud()
    protect = None
    if with_protect:
        protect = np.random.RandomState(3).rand(512) < 0.3
    jout = jp.prune(jpc, jst, 0.4, return_order=True,
                    protect=None if protect is None else jnp.asarray(protect))
    tout = tp.prune(tpc, tst, 0.4, return_order=True,
                    protect=None if protect is None
                    else torch.from_numpy(protect))
    _equal(tout[0], jout[0])
    assert int(tout[2]) == int(jout[2]) == int(tout[1].num_active)
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    conf = np.asarray(jpc.conf)[:300, 0]
    expect = (conf > 0.4) | (protect[:300] if with_protect else False)
    assert int(tout[2]) == int(expect.sum())
    # without return_order: three outputs, the same cloud
    pc3, _st3, kept3 = tp.prune(tpc, tst, 0.4, protect=None if protect is None
                                else torch.from_numpy(protect))
    _equal(pc3, jout[0])
    assert int(kept3) == int(jout[2])


@pytest.mark.parametrize("n_active,n_new", [(300, 50), (500, 40), (0, 7)])
def test_grow_matches_jax(n_active, n_new):
    """Appends into the tail; DEAD_XYZ rows are ignored; rows past the
    capacity (500 + 40 > 512) are dropped."""
    jpc, jst, tpc, tst = _cloud(n=n_active)
    rng = np.random.RandomState(n_new)
    new = [rng.uniform(-0.5, 0.5, (n_new, 3)).astype(np.float32)]
    new[0][::4] = jp.DEAD_XYZ
    for w in (8, 1, 3, 3):
        new.append(rng.rand(n_new, w).astype(np.float32))
    jout = jp.grow(jpc, jst, *[jnp.asarray(new[i]) for i in (0, 1, 2, 3, 4)])
    tout = tp.grow(tpc, tst, *[torch.from_numpy(new[i])
                               for i in (0, 1, 2, 3, 4)])
    _equal(tout[0], jout[0])
    assert int(tout[2]) == int(jout[2])
    assert int(tout[1].num_active) == int(jout[1].num_active)
    live = n_new - len(range(0, n_new, 4))
    assert int(tout[2]) == min(live, 512 - n_active)


@pytest.mark.parametrize("seed", [0, 1])
def test_query_points_matches_jax(interpret_pallas, seed):
    cfg = _cfg()
    pc, st, _params, grid, campos, camrot = setup(cfg, seed)
    item = make_batch(campos, camrot, R=48, seed=seed + 5)
    qj = j_query_points(pc.xyz, grid, jnp.asarray(campos),
                        jnp.asarray(item["raydir"]), 2.0, 4.5, cfg.query)
    from pointnerf_tpu_torch import config as tc
    from pointnerf_tpu_torch.train.step import refresh_grid
    tcfg = tc.PointNeRFConfig.from_json(cfg.to_json())
    tpc, tst = point_cloud_from_numpy(*[np.asarray(a) for a in pc],
                                      num_active=int(st.num_active),
                                      device="cpu")
    tgrid, _ = refresh_grid(tpc, tst, tcfg)
    qt = query_points(tpc.xyz, tgrid, torch.from_numpy(campos),
                      torch.from_numpy(item["raydir"]), 2.0, 4.5, tcfg.query)
    for f in ("sample_pidx", "sample_mask", "ray_mask"):
        np.testing.assert_array_equal(getattr(qt, f).numpy(),
                                      np.asarray(getattr(qj, f)), err_msg=f)
    np.testing.assert_allclose(qt.sample_loc_w.numpy(),
                               np.asarray(qj.sample_loc_w), rtol=0, atol=1e-6)
    assert qt.ray_mask.any() and not qt.ray_mask.all()
