"""Port decode (K3's plain version in pointnerf_tpu_torch/ops/fused_decode.py
and models/aggregator.aggregate) against the JAX fused decode (Pallas
interpret mode on the CPU) and the JAX aggregate, with the same weights
(convert.params_from_jax) and the same inputs.

Bars: 2e-4 in f32 (the decode parity bar of PERF.md "Numerical parity").
In bf16 both sides round the inputs, x and every hidden activation to bf16,
but a float32 sum that differs in its last bit (other summation order) can
round to the neighboring bf16 value (2^-8 relative) and carry through the
layers; the bf16 bar is 2e-2 of the output scale."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.config import tiny_test_config
from pointnerf_tpu.models.aggregator import aggregate as j_aggregate
from pointnerf_tpu.models.aggregator import block_dims as j_block_dims
from pointnerf_tpu.models.aggregator import init_aggregator_params
from pointnerf_tpu.models.points import SampledPoints as JSP
from pointnerf_tpu.ops.pallas_decode import DecodeSpec as JSpec
from pointnerf_tpu.ops.pallas_decode import fused_decode as j_fused_decode
from pointnerf_tpu_torch import config as tc
from pointnerf_tpu_torch.convert import params_from_jax
from pointnerf_tpu_torch.models import aggregator as ta
from pointnerf_tpu_torch.models.points import SampledPoints as TSP
from pointnerf_tpu_torch.ops.fused_decode import (DecodeSpec, fused_decode,
                                                  fused_decode_plain)

F32_TOL = 2e-4
BF16_TOL = 2e-2


# fixture copied from tests/test_pallas_decode.py
def _case(seed=0, R=6, SR=5, K=4, Fi=16):
    cfg = tiny_test_config()
    cfg = cfg.replace(agg=dataclasses.replace(
        cfg.agg, point_features_dim=Fi, shading_feature_num=64,
        fused_decode=True))
    rng = np.random.RandomState(seed)
    params = init_aggregator_params(jax.random.PRNGKey(seed), cfg.agg)
    mask = rng.rand(R, SR, K) > 0.3
    mask[:, 0] = True

    def f(*shape):
        return rng.normal(0, 0.3, shape).astype(np.float32)

    sp = dict(xyz=f(R, SR, K, 3), xyz_pers=f(R, SR, K, 3),
              features=f(R, SR, K, Fi),
              conf=rng.rand(R, SR, K, 1).astype(np.float32),
              color=f(R, SR, K, 3), dirs=f(R, SR, K, 3), mask=mask)
    sample_loc = f(R, SR, 3)
    sample_loc_w = f(R, SR, 3)
    rd = rng.normal(0, 1, (R, SR, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return cfg, params, sp, sample_loc, sample_loc_w, rd


def _spec_pair(cfg, K, bf16):
    a = cfg.agg
    d = dict(Fi=a.point_features_dim, Dd=a.dist_dim,
             E=3 * int(bool(a.point_color_mode)) + 4 * int(bool(
                 a.point_dir_mode)),
             Ff=a.num_feat_freqs, Fd=abs(a.dist_xyz_freq),
             H=a.shading_feature_num, K=K,
             L1=a.shading_feature_mlp_layer1,
             L3=a.shading_feature_mlp_layer3, neg_slope=0.01, bf16=bf16)
    return JSpec(**d, interpret=True, tile_rows=64), DecodeSpec(**d)


def _raw_inputs(spec, M, seed):
    rng = np.random.RandomState(seed)
    feat = rng.normal(0, 0.5, (M, spec.Fi)).astype(np.float32)
    dists = rng.normal(0, 0.05, (M, spec.Dd)).astype(np.float32)
    extras = rng.normal(0, 0.5, (M, spec.E)).astype(np.float32)
    w = (rng.rand(M, 1) * (rng.rand(M, 1) > 0.3)).astype(np.float32)
    return feat, dists, extras, w


@pytest.mark.parametrize("bf16,tol", [(False, F32_TOL), (True, BF16_TOL)])
@pytest.mark.parametrize("K", [4, 8])
def test_fused_decode_plain_matches_jax_kernel(bf16, tol, K):
    cfg, params, *_ = _case(seed=1, K=K)
    jspec, tspec = _spec_pair(cfg, K, bf16)
    M = 40 * K
    ins = _raw_inputs(tspec, M, seed=2)
    fj, aj = j_fused_decode(*[jnp.asarray(a) for a in ins], params, jspec)
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    ft, at = fused_decode(*[torch.from_numpy(a) for a in ins], tp, tspec)
    assert ft.shape == (M // K, tspec.H) and at.shape == (M // K, 1)
    scale = max(1.0, float(np.abs(fj).max()))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0,
                               atol=tol * scale)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=0,
                               atol=tol * scale)
    # the wrapper on CPU tensors is exactly the plain version
    ft2, at2 = fused_decode_plain(*[torch.from_numpy(a) for a in ins], tp,
                                  tspec)
    assert torch.equal(ft, ft2) and torch.equal(at, at2)


def _run_both(cfg, params, sp, sl, slw, rd, fused):
    c = cfg.replace(agg=dataclasses.replace(cfg.agg, fused_decode=fused))
    out_j = j_aggregate(params, c.agg, JSP(**{k: jnp.asarray(v)
                                            for k, v in sp.items()}),
                        jnp.asarray(sl), jnp.asarray(slw), jnp.asarray(rd),
                        c.query.vsize, Rw2c=jnp.eye(3))
    tcfg = tc.PointNeRFConfig.from_json(c.to_json())
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    out_t = ta.aggregate(tp, tcfg.agg, TSP(**{k: torch.from_numpy(v)
                                              for k, v in sp.items()}),
                         torch.from_numpy(sl), torch.from_numpy(slw),
                         torch.from_numpy(rd), tcfg.query.vsize,
                         Rw2c=torch.eye(3))
    return out_j, out_t


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("seed", [0, 3])
def test_aggregate_matches_jax(fused, seed):
    cfg, params, sp, sl, slw, rd = _case(seed=seed)
    out_j, out_t = _run_both(cfg, params, sp, sl, slw, rd, fused)
    np.testing.assert_allclose(out_t.features.numpy(),
                               np.asarray(out_j.features), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_array_equal(out_t.ray_valid.numpy(),
                                  np.asarray(out_j.ray_valid))
    np.testing.assert_allclose(out_t.weight.numpy(), np.asarray(out_j.weight),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(out_t.conf_coefficient.numpy(),
                               np.asarray(out_j.conf_coefficient), rtol=0,
                               atol=0)


def test_aggregate_no_color_dir_modes():
    """E = 0: extras disabled, on the fused and the plain branch."""
    cfg, _, sp, sl, slw, rd = _case(seed=5)
    cfg = cfg.replace(agg=dataclasses.replace(
        cfg.agg, point_color_mode=0, point_dir_mode=0))
    params = init_aggregator_params(jax.random.PRNGKey(5), cfg.agg)
    for fused in (True, False):
        out_j, out_t = _run_both(cfg, params, sp, sl, slw, rd, fused)
        np.testing.assert_allclose(out_t.features.numpy(),
                                   np.asarray(out_j.features),
                                   rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("mode", [-1, 0, 1, 2, 10, 20, 30])
def test_compute_dists_modes(mode):
    from pointnerf_tpu.models.aggregator import compute_dists as j_cd
    cfg, _, sp, sl, slw, rd = _case(seed=6)
    a = dataclasses.replace(cfg.agg, agg_dist_pers=mode)
    dj = j_cd(a, JSP(**{k: jnp.asarray(v) for k, v in sp.items()}),
              jnp.asarray(sl), jnp.asarray(slw), jnp.asarray(rd))
    ta_cfg = tc.AggregatorConfig(**dataclasses.asdict(a))
    dt = ta.compute_dists(ta_cfg, TSP(**{k: torch.from_numpy(v)
                                         for k, v in sp.items()}),
                          torch.from_numpy(sl), torch.from_numpy(slw),
                          torch.from_numpy(rd))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6,
                               atol=1e-6)


def test_block_dims_and_param_shapes_match():
    for cfg in (tiny_test_config(), tc.bench_config()):
        a = cfg.agg
        jd = j_block_dims(a)
        tdims = ta.block_dims(tc.AggregatorConfig(**dataclasses.asdict(a)))
        assert jd == tdims
    cfg = tiny_test_config()
    pj = init_aggregator_params(jax.random.PRNGKey(0), cfg.agg)
    pt = ta.init_aggregator_params(
        tc.AggregatorConfig(**dataclasses.asdict(cfg.agg)),
        torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda x: tuple(x.shape), pj) == {
        k: [{n: tuple(t.shape) for n, t in layer.items()} for layer in v]
        for k, v in pt.items()}


def test_out_of_envelope_raises():
    cfg, _, sp, sl, slw, rd = _case(seed=7)
    a = tc.AggregatorConfig(**dataclasses.asdict(
        dataclasses.replace(cfg.agg, agg_distance_kernel="quadric")))
    with pytest.raises(NotImplementedError, match="distance kernel"):
        ta.aggregate({}, a, TSP(**{k: torch.from_numpy(v)
                                   for k, v in sp.items()}),
                     torch.from_numpy(sl), torch.from_numpy(slw),
                     torch.from_numpy(rd), (0.1, 0.1, 0.1))
