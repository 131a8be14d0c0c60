"""The port's config (pointnerf_tpu_torch/config.py) against the JAX one:
same dataclasses, fields and defaults, and one opt.json loads in both."""
import dataclasses

import pytest

from pointnerf_tpu import config as J
from pointnerf_tpu_torch import config as T

CLASSES = ["QueryConfig", "AggregatorConfig", "RenderConfig", "PointsConfig",
           "LossConfig", "TrainConfig", "ParallelConfig", "DataConfig",
           "PointNeRFConfig"]


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        d = (f.default if f.default is not dataclasses.MISSING
             else f.default_factory())
        out.append((f.name, repr(d)))
    return out


@pytest.mark.parametrize("name", CLASSES)
def test_same_fields_and_defaults(name):
    assert _fields(getattr(T, name)) == _fields(getattr(J, name))


@pytest.mark.parametrize("maker", ["bench_config", "tiny_test_config",
                                   "lego_config"])
def test_named_configs_equal(maker):
    assert getattr(T, maker)().to_json() == getattr(J, maker)().to_json()


def _slice_cfg(mod):
    cfg = mod.bench_config()
    return cfg.replace(
        query=dataclasses.replace(cfg.query, knn_select="pallas", K=6,
                                  ranges=(-1.0, -0.5, -0.25, 1.0, 0.5, 0.25)),
        agg=dataclasses.replace(cfg.agg, fused_decode=True,
                                agg_axis_weight=(1.0, 0.5, 2.0)),
        render=dataclasses.replace(cfg.render, fused_march=True,
                                   bg_color=(0.0, 0.5, 1.0)),
        loss=dataclasses.replace(cfg.loss, depth_loss_items=("coarse_depth",),
                                 depth_loss_weights=(0.1,)),
        train=dataclasses.replace(cfg.train, track_hits=True))


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_opt_json_round_trip(direction):
    src, dst = (J, T) if direction == "jax_to_torch" else (T, J)
    s = _slice_cfg(src).to_json()
    loaded = dst.PointNeRFConfig.from_json(s)
    assert loaded.to_json() == s
    assert loaded == _slice_cfg(dst)
    assert loaded.query.ranges == (-1.0, -0.5, -0.25, 1.0, 0.5, 0.25)


@pytest.mark.parametrize("inverse,name", [(0, "near_far_linear"),
                                          (1, "near_far_linear"),
                                          (0, "near_middle_far")])
def test_effective_ray_generator(inverse, name):
    outs = []
    for mod in (J, T):
        cfg = mod.tiny_test_config()
        cfg = cfg.replace(
            query=dataclasses.replace(cfg.query, inverse=inverse),
            render=dataclasses.replace(cfg.render, which_ray_generation=name))
        outs.append((mod.effective_ray_generator(cfg),
                     mod.generator_kwargs(cfg)))
    assert outs[0] == outs[1]


def test_derived_properties():
    for maker in ("bench_config", "tiny_test_config"):
        a, b = getattr(J, maker)(), getattr(T, maker)()
        assert a.query.grid_bounds() == b.query.grid_bounds()
        assert a.query.radius_limit == b.query.radius_limit
        assert a.agg.dist_dim == b.agg.dist_dim
