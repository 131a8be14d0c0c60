"""The port's KNN branches (pointnerf_tpu_torch/ops/query.py `_knn_chunk`,
`knn_query`, `query_points`) against the JAX package's: bucket rows or
prebuilt tables, each with the K nearest, the shell-layered cut and the
NN=0 random subset, at tiny_test_config() as it is (bucket rows,
shell_layered, NN=2) and at K=8. Integers must be equal: neighbor ids, the
-1 / inf padding, slot and ray masks. Squared distances agree to 1e-6
relative (compiled JAX contracts their sum into multiply-adds). Ties go to
the lowest candidate index, as lax.top_k breaks them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.config import tiny_test_config
from pointnerf_tpu.ops import query as jq
from pointnerf_tpu.ops.grid import build_grid, grid_meta
from pointnerf_tpu_torch import config as tc
from pointnerf_tpu_torch.ops import grid as tg
from pointnerf_tpu_torch.ops import query as tq

BRANCHES = {
    "bucket, shell-layered": dict(),
    "bucket": dict(shell_layered=False),
    "bucket, NN=0": dict(NN=0),
    "bucket, NN=0, no shells": dict(NN=0, shell_layered=False),
    "tables, shell-layered": dict(prebuild_neighbors=True),
    "tables, NN=0": dict(prebuild_neighbors=True, NN=0),
    "tables (K1's plain version)": dict(prebuild_neighbors=True,
                                        shell_layered=False),
}


def _cfg(**kw):
    cfg = tiny_test_config()
    return cfg.replace(query=dataclasses.replace(cfg.query, **kw))


def _grids(cfg, xyz):
    gj = build_grid(jnp.asarray(xyz), jnp.asarray(xyz.shape[0], jnp.int32),
                    cfg.query)
    tcfg = tc.PointNeRFConfig.from_json(cfg.to_json())
    gt = tg.build_grid(torch.from_numpy(xyz), torch.tensor(xyz.shape[0]),
                       tcfg.query)
    return gj, gt, tcfg


def _cloud(n, seed):
    rng = np.random.RandomState(seed)
    return np.clip(rng.normal(0, 0.35, (n, 3)), -0.9, 0.9).astype(np.float32)


def _assert_same_knn(pj, dj, pt, dt):
    pj, dj = np.asarray(pj), np.asarray(dj)
    np.testing.assert_array_equal(pt.numpy(), pj)
    np.testing.assert_array_equal(np.isinf(dt.numpy()), np.isinf(dj))
    fin = np.isfinite(dj)
    np.testing.assert_allclose(dt.numpy()[fin], dj[fin], rtol=1e-6, atol=0)


@pytest.mark.parametrize("K", [4, 8])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_knn_chunk_matches_jax(branch, K):
    """One chunk of centers (a third invalid, some outside the grid)
    through JAX's `_knn_chunk` and the port's."""
    cfg = _cfg(K=K, **BRANCHES[branch])
    xyz = _cloud(1500, 0)
    rng = np.random.RandomState(1)
    centers = rng.uniform(-1.05, 1.05, (300, 3)).astype(np.float32)
    valid = rng.rand(300) > 0.3
    gj, gt, tcfg = _grids(cfg, xyz)
    pj, dj = jax.jit(lambda c, v: jq._knn_chunk(
        c, v, jnp.asarray(xyz), gj, grid_meta(cfg.query), cfg.query))(
        centers, valid)
    pt, dt = tq._knn_chunk(torch.from_numpy(centers), torch.from_numpy(valid),
                           gt, tg.grid_meta(tcfg.query), tcfg.query)
    _assert_same_knn(pj, dj, pt, dt)
    assert (pt >= 0).sum() > 100 and (pt < 0).any()


@pytest.mark.parametrize("kw", [dict(), dict(K=8, P=9)],
                         ids=["tiny", "K8P9"])
def test_shell_cut_and_random_subset_change_the_winners(kw):
    """The shell cut and the NN=0 subset are not the plain K nearest on
    these inputs (so the branch tests above test them), and each leaves
    the ids a subset of the in-radius candidates. (The center shell is one
    voxel of at most P points, so the cut needs P >= K.)"""
    xyz = _cloud(1500, 0)
    centers = torch.from_numpy(np.random.RandomState(1).uniform(
        -0.5, 0.5, (300, 3)).astype(np.float32))
    valid = torch.ones(300, dtype=torch.bool)
    out = {}
    for name, extra in (("knn", dict(shell_layered=False)),
                        ("shell", dict()), ("nn0", dict(NN=0))):
        tcfg = tc.PointNeRFConfig.from_json(_cfg(**kw, **extra).to_json())
        gt = tg.build_grid(torch.from_numpy(xyz), torch.tensor(1500),
                           tcfg.query)
        out[name] = tq._knn_chunk(centers, valid, gt,
                                  tg.grid_meta(tcfg.query), tcfg.query)
    assert not torch.equal(out["shell"][0], out["knn"][0])
    assert not torch.equal(out["nn0"][0], out["knn"][0])
    r2 = tcfg.query.radius_limit ** 2
    for name in ("shell", "nn0"):
        d2 = out[name][1]
        assert bool((d2[torch.isfinite(d2)] <= r2).all())


@pytest.mark.parametrize("branch", ["bucket", "bucket, shell-layered",
                                    "tables (K1's plain version)"])
def test_planted_ties_go_to_the_lowest_candidate(branch):
    """Every point twice (the copies under other ids, so exact d2 ties
    straddle the K-th place): the ids equal JAX's, and of a tied pair the
    winner is the copy in the lower candidate lane (the lower id inside one
    voxel)."""
    base = _cloud(400, 2)
    perm = np.random.RandomState(3).permutation(800)
    xyz = np.concatenate([base, base])[perm]
    for K in (1, 3):
        cfg = _cfg(K=K, **BRANCHES[branch])
        rng = np.random.RandomState(4)
        loc = rng.uniform(-0.8, 0.8, (11, 13, 3)).astype(np.float32)
        mask = rng.rand(11, 13) > 0.1
        gj, gt, tcfg = _grids(cfg, xyz)
        pj, dj = jax.jit(lambda l, m: jq.knn_query(
            l, m, jnp.asarray(xyz), gj, cfg.query))(loc, mask)
        pt, dt = tq.knn_query(torch.from_numpy(loc), torch.from_numpy(mask),
                              torch.from_numpy(xyz), gt, tcfg.query)
        _assert_same_knn(pj, dj, pt, dt)
        # of two copies, the lower id wins wherever only one made it in
        ids = pt.numpy().reshape(-1, K)
        inv = np.argsort(perm)        # base[b] sits at inv[b], inv[b + 400]
        twin = {int(i): int(j) for i, j in zip(inv[:400], inv[400:])}
        twin.update({j: i for i, j in twin.items()})
        lone = [(r, i) for r in ids for i in r
                if i >= 0 and twin[int(i)] not in r]
        assert lone and all(i < twin[int(i)] for _r, i in lone)


@pytest.mark.parametrize("branch", ["bucket, shell-layered", "bucket, NN=0",
                                    "tables, shell-layered"])
def test_chunking_changes_no_result(branch):
    """knn_chunk only bounds the workspace: 37 centers at a time give what
    the whole batch at once gives, and what JAX's chunked query gives."""
    xyz = _cloud(1500, 5)
    rng = np.random.RandomState(6)
    loc = rng.uniform(-1.0, 1.0, (17, 19, 3)).astype(np.float32)
    mask = rng.rand(17, 19) > 0.2
    res = {}
    for chunk in (37, 4096):
        cfg = _cfg(knn_chunk=chunk, **BRANCHES[branch])
        gj, gt, tcfg = _grids(cfg, xyz)
        pt, dt = tq.knn_query(torch.from_numpy(loc), torch.from_numpy(mask),
                              torch.from_numpy(xyz), gt, tcfg.query)
        pj, dj = jax.jit(lambda l, m: jq.knn_query(
            l, m, jnp.asarray(xyz), gj, cfg.query))(loc, mask)
        _assert_same_knn(pj, dj, pt, dt)
        res[chunk] = (pt, dt)
    assert torch.equal(res[37][0], res[4096][0])
    assert torch.equal(res[37][1], res[4096][1])


GENERATORS = sorted(jq.RAY_GENERATORS)


@pytest.mark.parametrize("jitter", [0.0, 0.3])
@pytest.mark.parametrize("branch", ["bucket, shell-layered", "bucket, NN=0",
                                    "tables, NN=0"])
def test_query_points_matches_jax(branch, jitter):
    """The whole query — every ray generator, slot selection and the KNN
    branch — against JAX's compiled query_points: neighbor ids, slot and ray
    masks equal, and the shading positions bit for bit (the NN=0 keys hash
    their bits). Every generator at K=4; the default one at K=8 too."""
    for K in (4, 8):
        cfg = _cfg(K=K, **BRANCHES[branch])
        xyz = _cloud(1500, 3)
        rng = np.random.RandomState(3)
        campos = np.array([0.1, -0.2, -3.0], np.float32)
        rd = rng.normal(0, 0.15, (48, 3)).astype(np.float32)
        rd[:, 2] = 1.0
        rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
        gj, gt, tcfg = _grids(cfg, xyz)
        D = cfg.query.z_depth_dim
        for name in (GENERATORS if K == 4 else ["near_far_linear"]):
            gk = ((("middle", 2.8), ("middle_split", 0.6))
                  if name == "near_middle_far" else ())
            key = jax.random.PRNGKey(4)
            qj = jq.query_points(jnp.asarray(xyz), gj, jnp.asarray(campos),
                                 jnp.asarray(rd), 2.0, 4.5, cfg.query,
                                 jitter=jitter, key=key if jitter else None,
                                 gen_name=name, gen_kwargs=gk)
            u = None
            if jitter:
                cols = {"near_far_disparity_linear": D + 1,
                        "near_middle_far": int(D * 0.6) + int(D * 0.4) + 2
                        }.get(name, D)
                u = torch.from_numpy(np.array(jax.random.uniform(
                    key, (48, cols), dtype=jnp.float32)))
            qt = tq.query_points(torch.from_numpy(xyz), gt,
                                 torch.from_numpy(campos),
                                 torch.from_numpy(rd), 2.0, 4.5, tcfg.query,
                                 jitter=jitter, u=u, gen_name=name,
                                 gen_kwargs=gk)
            for f in ("sample_pidx", "sample_mask", "ray_mask",
                      "sample_loc_w"):
                np.testing.assert_array_equal(
                    getattr(qt, f).numpy(), np.asarray(getattr(qj, f)),
                    err_msg=f"{name} {f}")
            assert int(qt.sample_mask.sum()) > 100
