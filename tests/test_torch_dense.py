"""The port's dense render (decode_capacity=0) and prob-mode probe outputs
(pointnerf_tpu_torch/models/renderer.render_rays, shade, _shade_at)
against the JAX package's, with the same weights, cloud and rays.

Config: the tiny_test_config of tests/test_torch_render.py in f32, the JAX
Pallas kernels in interpret mode, the port's kernels through their plain
versions on CPU tensors. Integers (masks, neighbor ids) must be equal;
floats, the probe outputs included, within 2e-4 (the decode bar of PERF.md
"Numerical parity").

The probe outputs are read at each ray's sample of largest opacity. The
port and JAX may differ there by up to the 1e-5 march bar, so a near tie
could pick another sample: every test asserts that the top-two opacity gap
of every ray that hits is wider than that bar, and fails, not loosens, when
it is not."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.models import renderer as jr
from pointnerf_tpu.models.renderer import RayBatch
from pointnerf_tpu.train.step import eval_step
from pointnerf_tpu_torch import config as tc
from pointnerf_tpu_torch.convert import params_from_jax, point_cloud_from_numpy
from pointnerf_tpu_torch.models import renderer as tr
from pointnerf_tpu_torch.train import step as ts
from test_torch_render import (FLOATS, INTS, TOL, _cfg, interpret_pallas,  # noqa: F401
                               make_batch, setup)

MARCH_BAR = 1e-5
PROB = ("ray_max_shading_opacity", "ray_max_sample_loc_w", "ray_max_far_dist",
        "shading_avg_color", "shading_avg_dir", "shading_avg_conf",
        "shading_avg_embedding")


def assert_argmax_margin(opacity: np.ndarray, bar: float = MARCH_BAR):
    """Every ray with a nonzero opacity has its largest one ahead of the
    second by more than `bar`."""
    op = np.sort(opacity, -1)
    hit = op[:, -1] > 0
    gap = op[hit, -1] - op[hit, -2]
    assert hit.any()
    assert gap.min() > bar, f"argmax near-tie: top-two gap {gap.min():.3e}"


def _scene(cfg, seed, R=64, colored=True):
    """JAX and port copies of one scene; the cloud carries colors and dirs
    (so the probe's averaged payloads are not all zero) and the alpha
    bias is raised so opacities are well above zero."""
    pc, st, params, grid, campos, camrot = setup(cfg, seed)
    if colored:
        rng = np.random.RandomState(seed + 7)
        n = pc.capacity
        pc = pc._replace(color=jnp.asarray(rng.rand(n, 3), jnp.float32),
                         dirs=jnp.asarray(rng.randn(n, 3), jnp.float32))
    params = jax.tree.map(lambda x: x, params)
    params["alpha"][0]["b"] = params["alpha"][0]["b"] + 3.0
    item = make_batch(campos, camrot, R=R, seed=seed + 1)
    jb = RayBatch(campos=jnp.asarray(campos), camrotc2w=jnp.asarray(camrot),
                  raydir=jnp.asarray(item["raydir"]),
                  pixel_idx=jnp.asarray(item["pixel_idx"]),
                  near=jnp.asarray(2.0), far=jnp.asarray(4.5))
    tcfg = tc.PointNeRFConfig.from_json(cfg.to_json())
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    tpc, tst = point_cloud_from_numpy(*[np.asarray(a) for a in pc],
                                      num_active=int(st.num_active),
                                      device="cpu")
    tgrid, _ = ts.refresh_grid(tpc, tst, tcfg)
    tb = tr.ray_batch_from_numpy(item, tcfg, device="cpu")
    return (params, pc, st, grid, jb), (tp, tpc, tst, tgrid, tb, tcfg)


def _assert_outputs(oj, ot, fields_int, fields_float):
    for f in fields_int:
        a, b = np.asarray(getattr(oj, f)), getattr(ot, f).numpy()
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    for f in fields_float:
        a, b = np.asarray(getattr(oj, f)), getattr(ot, f).numpy()
        assert a.shape == b.shape, f
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, err_msg=f)


@pytest.mark.parametrize("capacity,prob,fused,seed", [
    (0.0, False, True, 0), (0.0, True, True, 1), (0.5, True, True, 2),
    (0.0, True, False, 0)])
def test_dense_render_matches_jax(interpret_pallas, capacity, prob, fused,
                                  seed):
    """The dense decode (decode_capacity=0) and every probe (prob=True,
    dense whatever the capacity), fused and plain."""
    cfg = _cfg(fused=fused, capacity=capacity)
    (params, pc, st, grid, jb), (tp, tpc, tst, tgrid, tb, tcfg) = _scene(
        cfg, seed)
    oj = eval_step({"mlp": params, "points": pc}, st, grid, jb, cfg,
                   prob=prob)
    ot = ts.eval_step({"mlp": tp, "points": tpc}, tst, tgrid, tb, tcfg,
                      prob=prob)
    assert ot.decode_dropped is None and ot.neighbor_pidx.dim() == 3
    if prob:
        assert_argmax_margin(np.asarray(oj.coarse_point_opacity))
    ints = [f for f in INTS if f != "decode_dropped"]
    _assert_outputs(oj, ot, ints, FLOATS + (PROB if prob else ()))
    if not prob:
        assert all(getattr(ot, f) is None for f in PROB)
    else:
        assert float(ot.shading_avg_color.abs().max()) > 0
    assert ot.ray_mask.any() and not ot.ray_mask.all()


def test_dense_training_step_matches_jax(interpret_pallas):
    """Training through the dense decode (K4 on the card): the loss and the
    MLP gradients within 2e-4 of JAX's."""
    import dataclasses

    from pointnerf_tpu.train import step as js
    cfg = _cfg(capacity=0.0)
    cfg = cfg.replace(render=dataclasses.replace(cfg.render, train_jitter=0.0))
    (params, pc, st, grid, jb), (tp, tpc, tst, tgrid, tb, tcfg) = _scene(
        cfg, 0, colored=False)
    gt = np.random.RandomState(3).rand(64, 3).astype(np.float32)
    jb = jb._replace(gt_image=jnp.asarray(gt))
    tb = tb._replace(gt_image=torch.from_numpy(gt))
    (jtot, _), jg = jax.jit(lambda p, g, b: jax.value_and_grad(
        js.loss_fn, has_aux=True)(p, st, g, b, cfg, None))(
        {"mlp": params, "points": pc}, grid, jb)
    ttot, _items, tg = ts.loss_and_grads({"mlp": tp, "points": tpc}, tst,
                                         tgrid, tb, tcfg)
    np.testing.assert_allclose(ttot.numpy(), np.asarray(jtot), rtol=TOL)
    for a, b in zip(jax.tree.leaves(tg["mlp"], is_leaf=torch.is_tensor),
                    jax.tree.leaves(jg["mlp"])):
        scale = max(float(np.abs(np.asarray(b)).max()), 1e-12)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL * scale)


def test_shade_at_dense_branch_matches_jax(interpret_pallas):
    """`_shade_at` at explicit shading locations, dense branch (the fine
    pass's entry): the same outputs as JAX's, probe fields included."""
    from pointnerf_tpu.ops.query import generate_shading_points as j_gen
    from pointnerf_tpu_torch.ops.query import generate_shading_points
    cfg = _cfg(capacity=0.0)
    (params, pc, st, grid, jb), (tp, tpc, tst, tgrid, tb, tcfg) = _scene(
        cfg, 1)
    lj, mj = jax.jit(lambda g, b: j_gen(g, b.campos, b.raydir, 2.0, 4.5,
                                        cfg.query))(grid, jb)
    lt, mt = generate_shading_points(tgrid, tb.campos, tb.raydir, 2.0, 4.5,
                                     tcfg.query)
    oj = jax.jit(lambda p, c, g, b, loc, m: jr._shade_at(
        p, c, st, g, b, cfg, loc, m, prob=True, compute_dtype=jnp.float32))(
        params, pc, grid, jb, lj, mj)
    with torch.inference_mode():
        ot = tr._shade_at(tp, tpc, tst, tgrid, tb, tcfg, lt, mt, prob=True,
                          compute_dtype=torch.float32)
    assert_argmax_margin(np.asarray(oj.coarse_point_opacity))
    _assert_outputs(oj, ot, ("ray_valid", "ray_mask", "neighbor_pidx"),
                    FLOATS + PROB)
