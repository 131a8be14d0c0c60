"""Port query (pointnerf_tpu_torch/ops/query.py, K1's plain version in
ops/knn_select.py) against the JAX query with knn_select="pallas" (Pallas
interpret mode on the CPU). Integer outputs — shading-slot masks and
neighbor ids with their -1/inf padding — must be equal. Squared distances
agree to 1e-6 relative: the compiled JAX reference contracts the d2 sums into
fused multiply-adds on the CPU, while the port (and its CUDA kernel) rounds
every product and sum."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.config import tiny_test_config
from pointnerf_tpu.ops.grid import build_grid
from pointnerf_tpu.ops.pallas_knn import pallas_knn_select
from pointnerf_tpu.ops.query import generate_shading_points as j_gen
from pointnerf_tpu.ops.query import knn_query as j_knn
from pointnerf_tpu.ops.query import near_far_linear_ray_generation as j_rays
from pointnerf_tpu_torch import config as tc
from pointnerf_tpu_torch.ops import grid as tg
from pointnerf_tpu_torch.ops import query as tq
from pointnerf_tpu_torch.ops.knn_select import knn_select, knn_select_plain


# fixtures copied from tests/test_pallas_knn.py
def _cfg(**kw):
    cfg = tiny_test_config()
    q = dataclasses.replace(cfg.query, prebuild_neighbors=True,
                            shell_layered=False, NN=2, knn_select="pallas",
                            **kw)
    return cfg.replace(query=q)


def _scene(n=512, seed=0):
    rng = np.random.RandomState(seed)
    return rng.uniform(-0.9, 0.9, size=(n, 3)).astype(np.float32)


def _centers(r, sr, seed=1):
    rng = np.random.RandomState(seed)
    loc = rng.uniform(-1.0, 1.0, size=(r, sr, 3)).astype(np.float32)
    mask = rng.rand(r, sr) > 0.2
    return loc, mask


def _both(cfg, xyz, loc, mask):
    gj = build_grid(jnp.asarray(xyz), jnp.asarray(xyz.shape[0], jnp.int32),
                    cfg.query)
    pj, dj = j_knn(jnp.asarray(loc), jnp.asarray(mask), jnp.asarray(xyz), gj,
                   cfg.query)
    tq_cfg = tc.PointNeRFConfig.from_json(cfg.to_json()).query
    gt = tg.build_grid(torch.from_numpy(xyz), torch.tensor(xyz.shape[0]),
                       tq_cfg)
    pt, dt = tq.knn_query(torch.from_numpy(loc), torch.from_numpy(mask),
                          torch.from_numpy(xyz), gt, tq_cfg)
    return (np.asarray(pj), np.asarray(dj)), (pt.numpy(), dt.numpy())


@pytest.mark.parametrize("case", [
    dict(n=512, seed=0, r=13, sr=7, cseed=1, kw={}),           # odd C
    dict(n=2048, seed=3, r=9, sr=6, cseed=4,
         kw=dict(radius_limit_scale=0.5)),                      # tight radius
    dict(n=2048, seed=6, r=17, sr=11, cseed=7, kw=dict(K=8, P=9)),
    dict(n=64, seed=8, r=5, sr=3, cseed=9, kw=dict(K=8, P=2)),  # few points
])
def test_knn_query_matches_jax(case):
    cfg = _cfg(**case["kw"])
    loc, mask = _centers(case["r"], case["sr"], seed=case["cseed"])
    (pj, dj), (pt, dt) = _both(cfg, _scene(case["n"], case["seed"]), loc,
                               mask)
    assert pt.dtype == np.int32 and pt.shape == pj.shape
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(np.isinf(dt), np.isinf(dj))
    np.testing.assert_allclose(dt, dj, rtol=1e-6, atol=1e-7)
    assert (pt >= 0).any() and (pt == -1).any()


def test_knn_query_all_invalid_centers():
    loc, _ = _centers(4, 5)
    mask = np.zeros((4, 5), bool)
    (pj, dj), (pt, dt) = _both(_cfg(), _scene(64), loc, mask)
    assert np.all(pt == -1) and np.all(np.isinf(dt))
    np.testing.assert_array_equal(pt, pj)


def test_knn_select_plain_ties_match_pallas():
    """Duplicate candidate coordinates give exact d2 ties: both versions
    must break them toward the lowest lane. Direct call of the two kernels'
    contracts on synthetic rows (C odd, dead entries, invalid centers)."""
    rng = np.random.RandomState(10)
    C, QP, K, D = 37, 40, 6, 11
    base = rng.uniform(-0.3, 0.3, size=(D, QP, 3)).astype(np.float32)
    base[:, 20:30] = base[:, 0:10]             # ties between lanes
    base[:, 35:] = 1.0e8                       # dead table entries
    pid = rng.randint(0, 5000, size=(D, QP)).astype(np.int32)
    dslot = rng.randint(-1, D, size=C).astype(np.int32)
    centers = rng.uniform(-0.3, 0.3, size=(C, 3)).astype(np.float32)
    ok = rng.rand(C) > 0.2
    r2 = 0.09
    cand = base[np.maximum(dslot, 0)]
    pj, dj = pallas_knn_select(jnp.asarray(cand),
                               jnp.asarray(pid[np.maximum(dslot, 0)]),
                               jnp.asarray(centers),
                               jnp.asarray(ok & (dslot >= 0)), K=K, r2=r2)
    flat = np.concatenate([base[..., 0], base[..., 1], base[..., 2]], axis=1)
    args = (torch.from_numpy(flat), torch.from_numpy(pid),
            torch.from_numpy(dslot), torch.from_numpy(centers),
            torch.from_numpy(ok))
    pt, dt = knn_select(*args, K=K, r2=r2)      # CPU tensors: the plain path
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6,
                               atol=1e-7)
    pp, dp = knn_select_plain(*args, K, r2)
    assert torch.equal(pp, pt) and torch.equal(dp, dt)


def test_knn_select_plain_runs_match_pallas():
    """Slots in the main path's order — sorted runs of one shared table row
    (lengths up to 100), with invalid and -1 slots inside runs — and an r2
    cut: the plain version against the Pallas kernel (interpret mode)."""
    rng = np.random.RandomState(12)
    C, QP, K, D = 256, 60, 8, 9
    base = rng.uniform(-0.2, 0.2, size=(D, QP, 3)).astype(np.float32)
    base[:, 30:40] = base[:, 0:10]             # ties between candidates
    base[:, :, 0][rng.rand(D, QP) < 0.3] = 1.0e8
    lengths = [100, 3, 1, 57, 40, 55]
    dslot = np.repeat(rng.randint(0, D, size=len(lengths)),
                      lengths).astype(np.int32)
    dslot[rng.rand(C) < 0.05] = -1
    ok = rng.rand(C) > 0.05
    pid = rng.randint(0, 5000, size=(D, QP)).astype(np.int32)
    # centers near their row's candidates, so the cut keeps some of them
    centers = (base[np.maximum(dslot, 0), rng.randint(0, QP, size=C)]
               + rng.normal(0, 0.03, size=(C, 3))).astype(np.float32)
    centers[:, 0] = np.where(centers[:, 0] > 1e7, 0.0, centers[:, 0])
    r2 = 0.01
    cand = base[np.maximum(dslot, 0)]
    pj, dj = pallas_knn_select(jnp.asarray(cand),
                               jnp.asarray(pid[np.maximum(dslot, 0)]),
                               jnp.asarray(centers),
                               jnp.asarray(ok & (dslot >= 0)), K=K, r2=r2)
    flat = np.concatenate([base[..., 0], base[..., 1], base[..., 2]], axis=1)
    pt, dt = knn_select_plain(torch.from_numpy(flat), torch.from_numpy(pid),
                              torch.from_numpy(dslot),
                              torch.from_numpy(centers), torch.from_numpy(ok),
                              K, r2)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6,
                               atol=1e-7)
    pt = pt.numpy()
    assert (pt >= 0).any() and (pt[(pt >= 0).any(1)] == -1).any()


@pytest.mark.parametrize("K,route", [(1, 8), (8, 8), (9, 16), (16, 16),
                                     (17, 0), (243, 0)])
def test_knn_select_route_for(K, route):
    """The kernel path by K: the run path's register top-K holds 8 or 16,
    larger K takes the warp path."""
    from pointnerf_tpu_torch.ops.knn_select import route_for
    assert route_for(K) == route


def test_knn_select_checks_inputs():
    flat = torch.zeros((4, 30))
    pid = torch.zeros((4, 10), dtype=torch.int32)
    args = [flat, pid, torch.zeros(3, dtype=torch.int32), torch.zeros((3, 3)),
            torch.ones(3, dtype=torch.bool)]
    with pytest.raises(ValueError, match="dslot"):
        knn_select(flat, pid, torch.zeros(3, dtype=torch.int64), *args[3:],
                   K=2, r2=0.0)
    with pytest.raises(ValueError, match="K <= QP"):
        knn_select(*args, K=11, r2=0.0)


def test_ray_generation_depths_match_jax():
    """The per-sample depths (the numbers that decide which voxel a sample
    lands in) are bit-equal to the compiled JAX generator's."""
    rng = np.random.RandomState(11)
    rd = rng.randn(32, 3).astype(np.float32)
    cp = np.array([0.3, 0.8, -3.0], np.float32)
    for D, near, far in ((64, 2.0, 4.5), (400, 2.0, 4.5), (100, 0.5, 6.0)):
        _, seg_j, mid_j = jax.jit(
            lambda c, r: j_rays(c, r, D, near, far))(cp, rd)
        _, seg_t, mid_t = tq.near_far_linear_ray_generation(
            torch.from_numpy(cp), torch.from_numpy(rd), D, near, far)
        np.testing.assert_array_equal(mid_t.numpy(), np.asarray(mid_j))
        np.testing.assert_allclose(seg_t.numpy(), np.asarray(seg_j),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_select_shading_points_matches_jax(seed):
    """Occupancy-selected shading slots: sample_mask exact, positions to
    float32 rounding (1e-6)."""
    cfg = _cfg()
    rng = np.random.RandomState(20 + seed)
    xyz = np.clip(rng.normal(0, 0.25, (400, 3)), -0.9, 0.9).astype(
        np.float32)
    campos = np.array([0.1, -0.2, -3.0], np.float32)
    rd = rng.normal(0, 0.1, (48, 3)).astype(np.float32)
    rd[:, 2] = 1.0
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    gj = build_grid(jnp.asarray(xyz), jnp.asarray(400, jnp.int32), cfg.query)
    fj = jax.jit(lambda c, r: j_gen(gj, c, r, 2.0, 4.5, cfg.query))
    lj, mj = fj(campos, rd)
    tq_cfg = tc.PointNeRFConfig.from_json(cfg.to_json()).query
    gt = tg.build_grid(torch.from_numpy(xyz), torch.tensor(400), tq_cfg)
    lt, mt = tq.generate_shading_points(gt, torch.from_numpy(campos),
                                        torch.from_numpy(rd), 2.0, 4.5, tq_cfg)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert mt.numpy().any() and not mt.numpy().all()
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-6)
