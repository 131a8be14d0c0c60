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
`neural_render_from_flax` loads a 2D head's flax parameters into the
port's module layout, and `neural2d_state_from_jax` / `gan_state_from_jax`
carry the 2D-head training states (every group's Adam state, the style
codes, the discriminator and its Adam state, the EMA copies).
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
    holds them) -> (PointCloud, PointCloudStatic) on `device`. `Rw2c` is
    the global [3, 3] rotation (identity if None) or an editing
    composite's per-point [capacity, 3, 3]."""
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


def _adam_of(opt_state, g):
    """The ScaleByAdamState of group `g` of an optax multi_transform state,
    or of a plain optax.adam state when `g` is None; raises if a schedule
    beside it counts otherwise."""
    inner = (opt_state if g is None
             else opt_state.inner_states[g].inner_state)
    sched = [s for s in inner[1:] if "count" in getattr(s, "_fields", ())]
    if sched and int(np.asarray(sched[0].count)) != int(
            np.asarray(inner[0].count)):
        raise ValueError(f"group {g}: the schedule count differs from the "
                         "Adam count")
    return inner[0]


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
        adam = _adam_of(state.opt_state, g)
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


def mvs_variables_from_jax(variables, device: DeviceLike = None):
    """flax variables of `pointnerf_tpu.mvs.points_init.MvsPointsInit` (or
    of its MVSNet alone) with numpy leaves -> the port's {"params",
    "batch_stats"}, keyed by `mvs.points_init.MvsPointsInit` state_dict
    names (`premlp_0` -> `premlp.0`). Conv HWIO -> OIHW; Conv3D DHWIO ->
    OIDHW; ConvTranspose, stored by flax as (D, H, W, out, in) and flipped
    at apply time, -> ConvTranspose3d's (in, out, D, H, W) by the same
    transpose (4, 3, 0, 1, 2), no flip; Dense (in, out) -> Linear (out,
    in); BatchNorm scale / bias / mean / var -> weight / bias /
    running_mean / running_var."""
    dev = resolve_device(device)
    leaf_names = {"kernel": "weight", "scale": "weight", "bias": "bias",
                  "mean": "running_mean", "var": "running_var"}

    def walk(tree, path, out):
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(v, path + [k.replace("premlp_", "premlp.")], out)
                continue
            a = np.asarray(v, np.float32)
            if k == "kernel":
                if a.ndim == 4:
                    a = a.transpose(3, 2, 0, 1)
                elif a.ndim == 5:
                    a = a.transpose(4, 3, 0, 1, 2)
                elif a.ndim == 2:
                    a = a.T
            out[".".join(path + [leaf_names[k]])] = torch.tensor(
                np.ascontiguousarray(a), device=dev)
        return out
    return {"params": walk(dict(variables["params"]), [], {}),
            "batch_stats": walk(dict(variables.get("batch_stats", {})), [],
                                {})}


def neural_render_from_flax(module, tree, device: DeviceLike = None):
    """A head's flax parameter tree (numpy leaves) -> {state_dict name:
    tensor} of the port's module (`models.neural_render`, whose submodules
    carry flax's names). Conv kernels HWIO -> OIHW, no flip; Dense kernels
    [in, out] -> Linear's [out, in]; GroupNorm scale -> weight; Conv2DMod's
    "weight" HWIO -> OIHW and EqualLinear's [in, out] as they are (raw: the
    lr_mul and the modulation stay in forward). Raises unless the names and
    shapes are the module's."""
    dev = resolve_device(device)
    out = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(v, path + [k])
                continue
            a = np.asarray(v, np.float32)
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif k == "kernel" and a.ndim == 2:
                a = a.T
            name = {"kernel": "weight", "scale": "weight"}.get(k, k)
            out[".".join(path + [name])] = torch.tensor(
                np.ascontiguousarray(a), device=dev)
    walk(tree, [])
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in out.items()}
    if want != got:
        bad = [(k, got[k], want[k]) for k in want
               if k in got and got[k] != want[k]]
        raise ValueError(f"flax tree does not fit {type(module).__name__}: "
                         f"missing {sorted(set(want) - set(got))}, extra "
                         f"{sorted(set(got) - set(want))}, shapes {bad}")
    return out


def _neural2d_groups(tree, heads, dev):
    """The neural2d parameter groups of a JAX tree (numpy leaves):
    "mlp" and "points" as in train_state_from_jax, "style" a tensor, and
    each head group through `neural_render_from_flax(heads[group], ...)`."""
    out = {}
    for g, v in tree.items():
        if g == "mlp":
            out[g] = params_from_jax(v, dev)
        elif g == "points":
            out[g] = _points_from(v, dev)
        elif g == "style":
            out[g] = torch.tensor(np.asarray(v, np.float32), device=dev)
        else:
            out[g] = neural_render_from_flax(heads[g], v, dev)
    return out


def _adam_state(adam, conv, dev):
    from .train.optim import AdamState
    return AdamState(count=torch.tensor(int(np.asarray(adam.count)),
                                        dtype=torch.int32, device=dev),
                     mu=conv(adam.mu), nu=conv(adam.nu))


def _neural2d_opt(opt_state, params, heads, dev):
    """Each group's Adam state of a neural2d multi_transform state."""
    return {g: _adam_state(
        _adam_of(opt_state, g),
        lambda t, g=g: _neural2d_groups({g: t[g]}, heads, dev)[g], dev)
        for g in params}


def neural2d_state_from_jax(state, generator: torch.Generator, heads,
                            device: DeviceLike = None):
    """A JAX `train.neural2d.Neural2DState` with numpy leaves -> the port's
    `train.neural2d.Neural2DState`: `heads` maps "head" (and "stylevec")
    to the port's modules; each group's Adam state of the multi_transform
    carries over. `generator` takes the JAX key's place."""
    from .train.neural2d import Neural2DState
    dev = resolve_device(device)
    return Neural2DState(
        params=_neural2d_groups(state.params, heads, dev),
        opt_state=_neural2d_opt(state.opt_state, state.params, heads, dev),
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=dev), key=generator)


def gan_state_from_jax(state, generator: torch.Generator, heads, disc,
                       device: DeviceLike = None):
    """A JAX `train.neural2d.GANTrainState` with numpy leaves -> the port's:
    the generator side as `neural2d_state_from_jax`, the discriminator
    (`disc`, the port's module) and its optax.adam state, the EMA copies."""
    from .train.neural2d import GANTrainState
    dev = resolve_device(device)

    def d_conv(t):
        return neural_render_from_flax(disc, t, dev)
    return GANTrainState(
        params=_neural2d_groups(state.params, heads, dev),
        g_opt_state=_neural2d_opt(state.g_opt_state, state.params, heads,
                                  dev),
        d_params=d_conv(state.d_params),
        d_opt_state=_adam_state(_adam_of(state.d_opt_state, None), d_conv,
                                dev),
        ema=_neural2d_groups(state.ema, heads, dev),
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=dev), key=generator)
