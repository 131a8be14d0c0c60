"""Moving weights and clouds from numpy (or the JAX package's arrays, via
numpy) into the port, so the same parameters and points go into both.

`params_from_jax` takes the aggregator parameter tree of
`pointnerf_tpu.models.aggregator.init_aggregator_params` with its leaves
turned into numpy arrays (`jax.tree.map(np.asarray, params)`): lists of
{"w": [in, out], "b": [out]} under "block1", "block3", "alpha", "color"
(and any other head). The port keeps that layout, so nothing is transposed.
`train_state_from_jax` carries a whole training state across — parameters,
the optax Adam moments and counts of both groups, the step and the hit
counters — so a test can take a step from a mid-training state.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import DeviceLike, resolve_device
from .models.points import PointCloud, PointCloudStatic


def params_from_jax(tree, device: DeviceLike = None):
    """Nested dicts/lists of arrays -> the same nesting of float32 tensors
    on `device`."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.tensor(np.asarray(x, np.float32), device=dev)
    return conv(tree)


def point_cloud_from_numpy(xyz, features, conf, color, dirs,
                           num_active: int, Rw2c: Optional[np.ndarray] = None,
                           device: DeviceLike = None):
    """PointCloud fields (already padded to capacity, as the JAX PointCloud
    holds them) -> (PointCloud, PointCloudStatic) on `device`."""
    dev = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)
    pc = PointCloud(xyz=t(xyz), features=t(features), conf=t(conf),
                    color=t(color), dirs=t(dirs))
    st = PointCloudStatic(
        num_active=torch.tensor(int(num_active), dtype=torch.int32,
                                device=dev),
        Rw2c=t(np.eye(3, dtype=np.float32) if Rw2c is None else Rw2c))
    return pc, st


def _points_from(pc, dev) -> PointCloud:
    return PointCloud(*[torch.tensor(np.asarray(getattr(pc, f), np.float32),
                                     device=dev) for f in PointCloud._fields])


def train_state_from_jax(state, generator: torch.Generator,
                         device: DeviceLike = None):
    """A JAX `TrainState` with numpy leaves (`jax.tree.map(np.asarray,
    state)`; the optax containers stay as they are) -> the port's
    `train.step.TrainState` on `device`. The optimizer state is the
    `multi_transform` partition of `train/optim.make_optimizer`: per group a
    masked (ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))
    pair. The JAX PRNG key does not carry over: `generator` takes its place.
    """
    from .train.optim import AdamState
    from .train.step import TrainState
    dev = resolve_device(device)
    opt = {}
    for g in ("mlp", "points"):
        inner = state.opt_state.inner_states[g].inner_state
        adam = inner[0]
        sched = [s for s in inner[1:] if hasattr(s, "count")]
        if sched and int(np.asarray(sched[0].count)) != int(
                np.asarray(adam.count)):
            raise ValueError(f"group {g}: the schedule count differs from "
                             "the Adam count")
        conv = ((lambda t: params_from_jax(t, dev)) if g == "mlp"
                else (lambda t: _points_from(t, dev)))
        opt[g] = AdamState(
            count=torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32,
                               device=dev),
            mu=conv(adam.mu[g]), nu=conv(adam.nu[g]))
    hits = None if state.hits is None else torch.tensor(
        np.asarray(state.hits, np.float32), device=dev)
    return TrainState(
        params={"mlp": params_from_jax(state.params["mlp"], dev),
                "points": _points_from(state.params["points"], dev)},
        opt_state=opt,
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=dev),
        key=generator, hits=hits)
