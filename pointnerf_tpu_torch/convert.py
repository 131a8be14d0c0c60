"""Moving weights and clouds from numpy (or the JAX package's arrays, via
numpy) into the port, so the same parameters and points go into both.

`params_from_jax` takes the aggregator parameter tree of
`pointnerf_tpu.models.aggregator.init_aggregator_params` with its leaves
turned into numpy arrays (`jax.tree.map(np.asarray, params)`): lists of
{"w": [in, out], "b": [out]} under "block1", "block3", "alpha", "color"
(and any other head). The port keeps that layout, so nothing is transposed.
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
