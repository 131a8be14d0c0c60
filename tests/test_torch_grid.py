"""Port grid build (pointnerf_tpu_torch/ops/grid.py) against the JAX one:
every table equal entry for entry (integers and candidate coordinates are
copied, never computed, so the bar is exact), and refresh_grid's truncation
guard resizes past max_d and hands the size back."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.config import tiny_test_config
from pointnerf_tpu.models.points import make_point_cloud as j_make_pc
from pointnerf_tpu.ops.grid import build_grid as j_build
from pointnerf_tpu.ops.grid import kernel_offsets_layered as j_koffs
from pointnerf_tpu.train.step import refresh_grid as j_refresh
from pointnerf_tpu_torch import config as tc
from pointnerf_tpu_torch.convert import point_cloud_from_numpy
from pointnerf_tpu_torch.ops import grid as tg
from pointnerf_tpu_torch.train import step as ts

TABLES = ["vox_slot", "vox_occ", "bucket_pnt", "bucket_cnt", "num_occ",
          "bucket_xyz", "vox_dslot", "num_dil", "nbr_xyz", "nbr_pid",
          "occ_vids"]


def _cfg(**kw):
    cfg = tiny_test_config()
    return cfg.replace(query=dataclasses.replace(
        cfg.query, prebuild_neighbors=True, shell_layered=False, **kw))


def _tcfg(cfg):
    return tc.PointNeRFConfig.from_json(cfg.to_json())


def _cloud(n, n_active, seed, lo=-0.9, hi=0.9):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    xyz[n_active:] = 1.0e8
    return xyz


def _assert_grids_equal(gj, gt):
    for f in TABLES:
        a, b = getattr(gj, f), getattr(gt, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        a, b = np.asarray(a), b.cpu().numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (f, a.shape,
                                                           b.shape)
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("case", [
    dict(n=512, n_active=400, seed=0, kw={}),
    dict(n=700, n_active=700, seed=1, kw=dict(P=4)),          # overfull buckets
    dict(n=300, n_active=250, seed=2, kw=dict(kernel_size=(1, 1, 1))),
    dict(n=256, n_active=256, seed=3, kw=dict(max_o=64)),     # slot overflow
])
def test_build_grid_tables_equal(case):
    cfg = _cfg(**case["kw"])
    xyz = _cloud(case["n"], case["n_active"], case["seed"])
    gj = j_build(jnp.asarray(xyz), jnp.asarray(case["n_active"], jnp.int32),
                 cfg.query)
    gt = tg.build_grid(torch.from_numpy(xyz),
                       torch.tensor(case["n_active"], dtype=torch.int32),
                       _tcfg(cfg).query)
    _assert_grids_equal(gj, gt)


def test_points_on_voxel_faces_land_in_the_same_cell():
    """Coordinates exactly on (and one ulp off) voxel faces: the port's
    reciprocal multiply must floor like the compiled JAX build."""
    cfg = _cfg()
    meta = tg.grid_meta(_tcfg(cfg).query)
    lo = np.asarray(meta.lo, np.float32)
    vs = np.asarray(meta.scaled_vsize, np.float32)
    rng = np.random.RandomState(4)
    k = rng.randint(0, 12, size=(300, 3)).astype(np.float32)
    face = (lo + k * vs).astype(np.float32)
    xyz = np.concatenate([face, np.nextafter(face, np.float32(9)),
                          np.nextafter(face, np.float32(-9))])
    n = xyz.shape[0]
    gj = j_build(jnp.asarray(xyz), jnp.asarray(n, jnp.int32), cfg.query)
    gt = tg.build_grid(torch.from_numpy(xyz), torch.tensor(n), _tcfg(cfg).query)
    _assert_grids_equal(gj, gt)


def test_kernel_offsets_layered_equal():
    for ks in [(3, 3, 3), (1, 1, 1), (5, 3, 1)]:
        a_off, a_lay = j_koffs(ks)
        b_off, b_lay = tg.kernel_offsets_layered(ks)
        np.testing.assert_array_equal(a_off, b_off)
        np.testing.assert_array_equal(a_lay, b_lay)


def test_refresh_grid_resizes_past_max_d(monkeypatch, capsys):
    import jax
    cfg = _cfg(max_d=256)
    xyz = _cloud(600, 600, seed=5)
    pcj, stj = j_make_pc(xyz, jax.random.PRNGKey(0), cfg.points,
                         cfg.agg.point_features_dim, capacity=1024)
    gj = j_refresh(pcj, stj, cfg)
    assert gj.nbr_pid.shape[0] > 256
    pct, stt = point_cloud_from_numpy(*[np.asarray(a) for a in pcj],
                                      num_active=600, device="cpu")
    tcfg = _tcfg(cfg)
    gt, max_d = ts.refresh_grid(pct, stt, tcfg)
    assert "rebuilding with max_d" in capsys.readouterr().out
    assert max_d == gt.nbr_pid.shape[0] == gj.nbr_pid.shape[0]
    _assert_grids_equal(gj, gt)
    # handing the size back: the next refresh builds once, no resize
    calls = []
    real = ts.build_grid
    monkeypatch.setattr(ts, "build_grid",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    gt2, max_d2 = ts.refresh_grid(pct, stt, tcfg, max_d=max_d)
    assert len(calls) == 1 and max_d2 == max_d
    _assert_grids_equal(gj, gt2)
