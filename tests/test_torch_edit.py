"""Scene editing in the port (pointnerf_tpu_torch/edit.py and the
per-neighbor rotation path of the aggregator and the renderer) against the
JAX package's, with the same parts, weights and rays.

- compose_parts: the cloud and the per-point Rw2c equal JAX's.
- Identity, rotated and two-part composites render as JAX's eval_step does
  at the serving bars (integers equal, colors 1e-5), on the compacted path
  with the fused flags (JAX's Pallas kernels in interpret mode, the port's
  plain versions) and, for the two-part composite, on the dense unfused
  path and with the fine pass (which gathers the rotations again at its
  resampled points); one train step's loss and aggregator gradients of the
  rotated composite within the 2e-4 gradient bar.
- On the port alone: one part at R = I renders as the global-Rw2c path;
  a part rotated by R seen by a camera rotated by R renders the unrotated
  image (frame invariance), where the same composite with its per-point
  rotations set to I does not (the control).
Mirrors tests/test_edit.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.edit import ScenePart as JPart
from pointnerf_tpu.edit import compose_parts as j_compose
from pointnerf_tpu.models.aggregator import init_aggregator_params
from pointnerf_tpu.models.renderer import RayBatch
from pointnerf_tpu.train import step as js
from pointnerf_tpu_torch import config as tc
from pointnerf_tpu_torch.convert import params_from_jax
from pointnerf_tpu_torch.edit import ScenePart as TPart
from pointnerf_tpu_torch.edit import compose_parts as t_compose
from pointnerf_tpu_torch.models import renderer as tr
from pointnerf_tpu_torch.models.points import PointCloudStatic
from pointnerf_tpu_torch.train import step as ts
from test_torch_render import _cfg, make_batch, synthetic_scene

INTS = ("ray_valid", "ray_mask", "decode_dropped", "neighbor_pidx")
COLOR_TOL = 1e-5
GRAD_TOL = 2e-4
# 90 degrees about z
RZ = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)


def _arrays(xyz, F, seed):
    rng = np.random.RandomState(seed)
    n = len(xyz)
    return dict(xyz=xyz.astype(np.float32),
                features=rng.rand(n, F).astype(np.float32) * 0.5,
                conf=np.full((n, 1), 0.5, np.float32),
                color=rng.rand(n, 3).astype(np.float32),
                dirs=rng.normal(size=(n, 3)).astype(np.float32))


def _parts(kind, F):
    """The parts of each composite, as keyword dicts for either package."""
    xyz, _, _ = synthetic_scene(n_pts=300)
    if kind == "identity":
        return [_arrays(xyz, F, 0)]
    if kind == "rotated":
        return [dict(_arrays(xyz, F, 0), R=RZ,
                     t=np.array([0.1, 0.0, 0.05], np.float32))]
    half = xyz * 0.5
    return [dict(_arrays(half + [0.35, 0, 0], F, 0),
                 crop_aabb=(0.2, -1, -1, 1, 1, 1)),
            dict(_arrays(half, F, 1), R=RZ,
                 t=np.array([-0.35, 0.0, 0.0], np.float32))]


def _composite(kind, cfg):
    spec = _parts(kind, cfg.agg.point_features_dim)
    jpc, jst = j_compose([JPart(**p) for p in spec])
    tpc, tst = t_compose([TPart(**p) for p in spec], device="cpu")
    return jpc, jst, tpc, tst


def _batches(cfg, tcfg, campos, camrot, R=96):
    item = make_batch(campos, camrot, R=R, seed=3)
    item["gt_image"] = np.random.RandomState(4).rand(R, 3).astype(np.float32)
    jb = RayBatch(campos=jnp.asarray(campos), camrotc2w=jnp.asarray(camrot),
                  raydir=jnp.asarray(item["raydir"]),
                  pixel_idx=jnp.asarray(item["pixel_idx"]),
                  near=jnp.asarray(2.0), far=jnp.asarray(4.5),
                  gt_image=jnp.asarray(item["gt_image"]))
    return jb, tr.ray_batch_from_numpy(item, tcfg, device="cpu")


def _dense_cfg():
    return _cfg(fused=False, capacity=0.0)


def _fine_cfg():
    cfg = _cfg()
    return cfg.replace(render=dataclasses.replace(cfg.render,
                                                  fine_sample_num=8))


@pytest.fixture(scope="module")
def renders():
    """JAX's and the port's eval renders of every (config, composite) case,
    and one train step of the rotated composite in both packages, under
    one compile per config."""
    import jax.experimental.pallas as pl
    mp = pytest.MonkeyPatch()
    orig = pl.pallas_call
    mp.setattr(pl, "pallas_call",
               lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    out = {}
    try:
        for cname, cfg, kinds in (
                ("compact", _cfg(), ("identity", "rotated", "two_part")),
                ("dense", _dense_cfg(), ("two_part",)),
                ("fine", _fine_cfg(), ("two_part",))):
            tcfg = tc.PointNeRFConfig.from_json(cfg.to_json())
            params = init_aggregator_params(jax.random.PRNGKey(1), cfg.agg)
            tp = params_from_jax(jax.tree.map(np.asarray, params),
                                 device="cpu")
            _xyz, campos, camrot = synthetic_scene(n_pts=300)
            jb, tb = _batches(cfg, tcfg, campos, camrot)
            for kind in kinds:
                jpc, jst, tpc, tst = _composite(kind, cfg)
                jgrid = js.refresh_grid(jpc, jst, cfg)
                tgrid, _ = ts.refresh_grid(tpc, tst, tcfg)
                oj = js.eval_step({"mlp": params, "points": jpc}, jst, jgrid,
                                  jb, cfg)
                ot = ts.eval_step({"mlp": tp, "points": tpc}, tst, tgrid, tb,
                                  tcfg)
                out[cname, kind] = (oj, ot)
                if (cname, kind) == ("compact", "rotated"):
                    (jl, _), jg = jax.jit(lambda p, g: jax.value_and_grad(
                        js.loss_fn, has_aux=True)(p, jst, g, jb, cfg, None))(
                            {"mlp": params, "points": jpc}, jgrid)
                    tl, _, tg = ts.loss_and_grads(
                        {"mlp": tp, "points": tpc}, tst, tgrid, tb, tcfg)
                    out["grads"] = (jl, jg, tl, tg)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("kind", ["identity", "rotated", "two_part"])
def test_compose_parts_matches_jax(kind):
    cfg = _cfg()
    jpc, jst, tpc, tst = _composite(kind, cfg)
    for f in jpc._fields:
        np.testing.assert_array_equal(getattr(tpc, f).numpy(),
                                      np.asarray(getattr(jpc, f)), err_msg=f)
    assert int(tst.num_active) == int(jst.num_active)
    assert tst.Rw2c.shape == (tpc.capacity, 3, 3)
    np.testing.assert_array_equal(tst.Rw2c.numpy(), np.asarray(jst.Rw2c))
    if kind == "two_part":
        n0 = int(np.all(_parts(kind, 8)[0]["xyz"] >= [0.2, -1, -1], -1).sum())
        assert 0 < n0 < 300 and int(tst.num_active) == n0 + 300


@pytest.mark.parametrize("case", [("compact", "identity"),
                                  ("compact", "rotated"),
                                  ("compact", "two_part"),
                                  ("dense", "two_part"),
                                  ("fine", "two_part")])
def test_composite_render_matches_jax(renders, case):
    oj, ot = renders[case]
    for f in INTS:
        if getattr(oj, f) is None:
            continue
        np.testing.assert_array_equal(getattr(ot, f).numpy(),
                                      np.asarray(getattr(oj, f)), err_msg=f)
    hit = np.asarray(oj.ray_mask)
    assert hit.sum() > 10
    np.testing.assert_allclose(ot.coarse_raycolor.numpy()[hit],
                               np.asarray(oj.coarse_raycolor)[hit],
                               rtol=0, atol=COLOR_TOL)
    if case[0] == "fine":       # the fine pass decodes the composite again
        np.testing.assert_array_equal(ot.fine_neighbor_pidx.numpy(),
                                      np.asarray(oj.fine_neighbor_pidx))
        np.testing.assert_allclose(ot.fine_raycolor.numpy()[hit],
                                   np.asarray(oj.fine_raycolor)[hit],
                                   rtol=0, atol=COLOR_TOL)


def test_composite_train_gradients_match_jax(renders):
    jl, jg, tl, tg = renders["grads"]
    np.testing.assert_allclose(float(tl), float(jl), rtol=GRAD_TOL)
    for name, layers in tg["mlp"].items():
        for i, layer in enumerate(layers):
            for k in ("w", "b"):
                a = layer[k].numpy()
                b = np.asarray(jg["mlp"][name][i][k])
                np.testing.assert_allclose(
                    a, b, rtol=0, atol=GRAD_TOL * max(np.abs(b).max(), 1e-6),
                    err_msg=f"{name}.{i}.{k}")


def _port_render(tpc, tst, tcfg, tp, campos, camrot):
    tgrid, _ = ts.refresh_grid(tpc, tst, tcfg)
    _jb, tb = _batches(None, tcfg, campos, camrot)
    return ts.eval_step({"mlp": tp, "points": tpc}, tst, tgrid, tb, tcfg)


def _port_setup():
    cfg = _cfg()
    tcfg = tc.PointNeRFConfig.from_json(cfg.to_json())
    tp = params_from_jax(jax.tree.map(
        np.asarray, init_aggregator_params(jax.random.PRNGKey(1), cfg.agg)),
        device="cpu")
    return cfg, tcfg, tp


def test_identity_part_renders_as_the_global_path():
    cfg, tcfg, tp = _port_setup()
    _xyz, campos, camrot = synthetic_scene(n_pts=300)
    _j, _js, tpc, tst = _composite("identity", cfg)
    edit = _port_render(tpc, tst, tcfg, tp, campos, camrot)
    glob = _port_render(tpc, PointCloudStatic(tst.num_active, torch.eye(3)),
                        tcfg, tp, campos, camrot)
    for f in INTS:
        assert torch.equal(getattr(edit, f), getattr(glob, f)), f
    torch.testing.assert_close(edit.coarse_raycolor, glob.coarse_raycolor,
                               rtol=0, atol=COLOR_TOL)


def test_rotated_part_is_frame_invariant():
    """A part rotated by R about the origin, seen by the camera rotated by
    R, renders the unrotated part's image; the control (the same composite
    with its per-point rotations set to I) does not."""
    cfg, tcfg, tp = _port_setup()
    xyz, campos, camrot = synthetic_scene(n_pts=300)
    base = _arrays(xyz, cfg.agg.point_features_dim, 0)
    pc0, st0 = t_compose([TPart(**base)], device="cpu")
    ref = _port_render(pc0, st0, tcfg, tp, campos, camrot)
    R = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32)
    pc1, st1 = t_compose([TPart(**base, R=R)], device="cpu")
    out = _port_render(pc1, st1, tcfg, tp, R @ campos, R @ camrot)
    ctl = _port_render(pc1, st1._replace(Rw2c=torch.eye(3).expand_as(
        st1.Rw2c).contiguous()), tcfg, tp, R @ campos, R @ camrot)
    m = (ref.ray_mask & out.ray_mask).numpy()
    assert m.sum() > 10
    a = ref.coarse_raycolor.numpy()[m]
    err = np.median(np.abs(out.coarse_raycolor.numpy()[m] - a))
    ctl_err = np.median(np.abs(ctl.coarse_raycolor.numpy()[m] - a))
    assert err < 0.02, err
    assert ctl_err > 2 * err and ctl_err > 1e-3, (err, ctl_err)
