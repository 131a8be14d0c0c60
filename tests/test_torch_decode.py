"""Port decode (the plain versions of K3 and K4 in
pointnerf_tpu_torch/ops/fused_decode.py and models/aggregator.aggregate)
against the JAX fused decode and its custom VJP (Pallas interpret mode on
the CPU) and the JAX aggregate, with the same weights
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
                                                  fused_decode_bwd_plain,
                                                  fused_decode_plain,
                                                  kernel_takes)

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


def _bwd_case(K, bf16, seed):
    """The same decode inputs, weights and upstream gradients through the
    JAX custom VJP (`_bwd_rule`, interpret mode) and into the port."""
    cfg, params, *_ = _case(seed=seed, K=K)
    jspec, tspec = _spec_pair(cfg, K, bf16)
    M = 40 * K
    ins = _raw_inputs(tspec, M, seed=seed + 1)
    sub = {k: params[k] for k in ("block1", "block3", "alpha")}
    rng = np.random.RandomState(9)
    gf = rng.normal(0, 1, (M // K, tspec.H)).astype(np.float32)
    ga = rng.normal(0, 1, (M // K, 1)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c, d, p: j_fused_decode(a, b, c, d, p,
                                                          jspec),
                     *[jnp.asarray(a) for a in ins], sub)
    gj = vjp((jnp.asarray(gf), jnp.asarray(ga)))
    tp = params_from_jax(jax.tree.map(np.asarray, sub), device="cpu")
    return ([torch.from_numpy(a) for a in ins], tp, tspec,
            torch.from_numpy(gf), torch.from_numpy(ga), gj)


def _rel_errs(t_grads, j_grads):
    """Per gradient leaf (row gradients, then every dW/db in the same tree
    order): max |port - JAX| / max |JAX|."""
    tl = jax.tree.leaves(t_grads, is_leaf=torch.is_tensor)
    jl = [np.asarray(x) for x in jax.tree.leaves(j_grads)]
    assert [tuple(t.shape) for t in tl] == [x.shape for x in jl]
    return [float(np.abs(t.detach().numpy() - x).max() / np.abs(x).max())
            for t, x in zip(tl, jl)]


@pytest.mark.parametrize("K", [4, 8])
def test_fused_decode_bwd_plain_matches_jax_f32(K):
    """f32: the plain backward against JAX's `_bwd_rule` and against torch
    autograd of the plain forward, every leaf within 2e-4 of its scale; the
    autograd Function on CPU tensors runs exactly the plain backward."""
    ins, tp, spec, gf, ga, gj = _bwd_case(K, bf16=False, seed=1)
    gt = fused_decode_bwd_plain(*ins, tp, spec, gf, ga)
    assert max(_rel_errs(gt, gj)) <= F32_TOL
    flat = [t for name in ("block1", "block3", "alpha") for layer in gt[4][name]
            for t in (layer["w"], layer["b"])]

    def grads_of(fn):
        xs = [a.clone().requires_grad_() for a in ins]
        p = jax.tree.map(lambda t: t.clone().requires_grad_(), tp)
        leaves = [layer[n] for name in ("block1", "block3", "alpha")
                  for layer in p[name] for n in ("w", "b")]
        f, a = fn(*xs, p, spec)
        return torch.autograd.grad((f * gf).sum() + (a * ga).sum(),
                                   xs + leaves)
    for a, b in zip(grads_of(fused_decode_plain), list(gt[:4]) + flat):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= F32_TOL * max(scale, 1e-12)
    for a, b in zip(grads_of(fused_decode), list(gt[:4]) + flat):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K", [4, 8])
def test_fused_decode_bwd_plain_matches_jax_bf16(K):
    """bf16: both backwards round inputs, activations, weights and every g_z
    at the same places, but a neighboring bf16 value after a last-bit f32
    difference carries through the layers (readings on these inputs: at most
    4.6e-3 of a leaf's scale over K in {4, 8} and seeds 1-3). Bar 2e-2, as
    for the bf16 forward; the control, the f32 plain backward in place of
    the bf16 one, lands above it (readings 0.17 to 0.41)."""
    ins, tp, spec, gf, ga, gj = _bwd_case(K, bf16=True, seed=2)
    err = max(_rel_errs(fused_decode_bwd_plain(*ins, tp, spec, gf, ga), gj))
    control = max(_rel_errs(fused_decode_bwd_plain(
        *ins, tp, spec._replace(bf16=False), gf, ga), gj))
    assert err <= BF16_TOL < control


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


# the bf16 route's tensor-core kernels (csrc/fused_decode_tc.cu,
# csrc/fused_decode_bwd_tc.cu): their limits, shared memory and weight
# packing, mirrored in Python where the CPU can check them
def _bench_spec(**kw):
    d = dict(Fi=32, Dd=6, E=7, Ff=3, Fd=5, H=256, K=8, L1=2, L3=2,
             neg_slope=0.01, bf16=True)
    d.update(kw)
    return DecodeSpec(**d)


@pytest.mark.parametrize("kw,fwd,bwd", [
    ({}, True, True),                             # bench_config
    (dict(H=128, L1=1, L3=1), True, True),        # a second width
    (dict(L1=4, L3=4), True, True),               # eight 256-wide layers
    (dict(H=32), True, True),
    (dict(H=512), False, False),                  # past 256 columns
    (dict(H=48), False, False),                   # not a multiple of 32
    (dict(K=3), False, False),                    # 64 % K != 0
    (dict(L1=5, L3=4), False, False),             # nine layers
    (dict(Fi=64), False, False),                  # x1 = 508 > 320
    (dict(Fi=8, Ff=2, Fd=0), True, True),         # no dists PE
])
def test_tc_kernel_takes_mirrors_the_kernels_limits(kw, fwd, bwd):
    spec = _bench_spec(**kw)
    assert kernel_takes(spec) == fwd
    assert kernel_takes(spec, backward=True) == bwd


def test_tc_smem_formulas_at_bench_config():
    """The shared memory of each tensor-core kernel at bench_config, worked
    out from the layouts in the sources: layer inputs padded to 32 (288,
    256, 288, 256), bf16 rows padded by 8."""
    from pointnerf_tpu_torch.ops.fused_decode import (tc_bwd_smem_bytes,
                                                      tc_pads, tc_smem_bytes)
    spec = _bench_spec()
    assert tc_pads(spec) == [288, 256, 288, 256]
    # K3: 64 rows x 296 bf16 activations, 3 ring stages of 32 x 264 bf16,
    # two floats per row
    assert tc_smem_bytes(spec) == 64 * 296 * 2 + 3 * 32 * 264 * 2 + 64 * 8
    # K4 phase A: max(64 x 296 bf16, 64 x 292 f32), g_zr 64 x 264 bf16,
    # z-sign bits 4 layers x 64 rows x 8 words, 3 stages of the larger of
    # 32 x 264 and 288 x 40 bf16, two floats per row; phase B: two stages
    # of 64 x 296 and 64 x 72 bf16
    a = 64 * 292 * 4 + 64 * 264 * 2 + 4 * 64 * 8 * 4 + 3 * 288 * 40 * 2 \
        + 64 * 8
    assert tc_bwd_smem_bytes(spec) == (a, 2 * 2 * 64 * (296 + 72))
    assert max(tc_bwd_smem_bytes(_bench_spec(L1=4, L3=4))) <= 232448


@pytest.mark.parametrize("bf16", [True, False])
def test_refusal_names_the_route(bf16):
    from pointnerf_tpu_torch.ops.fused_decode import _refuse
    bad = _bench_spec(H=512, bf16=bf16)
    what = "tensor-core kernels" if bf16 else "CUDA kernels"
    with pytest.raises(ValueError, match=f"the {what} do not take"):
        _refuse(bad, backward=True)
    _refuse(_bench_spec(bf16=bf16), backward=True)      # takes it


@pytest.mark.parametrize("kw", [{}, dict(H=128, L1=1, L3=1)])
def test_pack_tc_weights_round_trip(kw):
    """pack_tc_weights lays each W out as both streams expect: every weight
    reads back from either stream, and the padding rows are zero."""
    from pointnerf_tpu_torch.ops.fused_decode import (TC_KC, layer_inputs,
                                                      pack_tc_weights,
                                                      tc_pads)
    spec = _bench_spec(**kw)
    g = torch.Generator().manual_seed(0)
    Ws = [torch.randn((n, spec.H), generator=g).to(torch.bfloat16).float()
          for n in layer_inputs(spec)]
    buf = pack_tc_weights(Ws, spec)
    pads = tc_pads(spec)
    assert buf.dtype == torch.bfloat16
    assert buf.numel() == 2 * sum(pads) * spec.H
    n, off = sum(pads) * spec.H, 0
    for W, kp in zip(Ws, pads):
        k, size = W.shape[0], kp * spec.H
        fwd = buf[off:off + size].view(kp, spec.H).float()
        bwd = buf[n + off:n + off + size].view(spec.H // TC_KC, kp, TC_KC)
        bwd = bwd.permute(1, 0, 2).reshape(kp, spec.H).float()
        for t in (fwd, bwd):
            assert torch.equal(t[:k], W) and not bool(t[k:].any())
        off += size
    # one element by hand: layer 1 starts at kp_0 * H in each stream; the
    # backward stream holds column block j of W_1 as [kp_1, 32]
    off, kp, H = pads[0] * spec.H, pads[1], spec.H
    assert float(buf[off + 5 * H + 70]) == float(Ws[1][5, 70])
    assert float(buf[n + off + 2 * kp * 32 + 7 * 32 + 3]) \
        == float(Ws[1][7, 2 * 32 + 3])


def test_plain_f64_sums_the_same_function():
    """dtype=float64 runs the plain versions' products and sums in f64 and
    returns f32: without bf16 rounding points it is the f32 function up to
    summation order (readings ~1e-7 of each output's scale)."""
    ins, tp, spec, gf, ga, _gj = _bwd_case(4, bf16=False, seed=3)
    f32 = fused_decode_plain(*ins, tp, spec)
    f64 = fused_decode_plain(*ins, tp, spec, dtype=torch.float64)
    b32 = jax.tree.leaves(fused_decode_bwd_plain(*ins, tp, spec, gf, ga),
                          is_leaf=torch.is_tensor)
    b64 = jax.tree.leaves(fused_decode_bwd_plain(*ins, tp, spec, gf, ga,
                                                 dtype=torch.float64),
                          is_leaf=torch.is_tensor)
    for a, b in zip(list(f64) + b64, list(f32) + b32):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
