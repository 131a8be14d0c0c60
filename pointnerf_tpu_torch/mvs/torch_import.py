"""Import the reference's pretrained torch MVSNet checkpoint into the port.

Counterpart of `pointnerf_tpu/mvs/torch_import.py`
(`convert_mvsnet_state_dict`, `load_mvsnet_checkpoint`). The port's MVSNet
keeps the reference's module names and PyTorch's weight layouts, so the map
is by name only: the deconvolution blocks' `nn.Sequential` entries `.0`
(ConvTranspose3d) and `.1` (BatchNorm3d) become `.deconv` and `.bn`, a
leading "module." (DataParallel) is dropped, and `num_batches_tracked` and
the optional `refine_network` are ignored. The BatchNorm's weight, bias,
running_mean and running_var land on `FlaxBatchNorm`'s parameters and
buffers of the same names. Use it with MvsPointsInit(align_corners=False).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_PARAMS = ("weight", "bias")
_STATS = ("running_mean", "running_var")


def _t(v) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(v, np.float32))


def convert_mvsnet_state_dict(sd: Mapping
                              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Reference MVSNet.state_dict() -> {"params", "batch_stats"} keyed by
    the port's MVSNet names (without the "mvsnet." of MvsPointsInit), CPU
    float32 tensors."""
    params: Dict[str, torch.Tensor] = {}
    stats: Dict[str, torch.Tensor] = {}
    for key, val in sd.items():
        parts = key.split(".")
        if parts[0] == "module":
            parts = parts[1:]
        if parts[-1] == "num_batches_tracked" or parts[0] == "refine_network":
            continue
        if parts[0] not in ("feature", "cost_regularization"):
            continue
        if parts[1] in ("conv7", "conv9", "conv11"):
            sub = {"0": "deconv", "1": "bn"}.get(parts[2])
            if sub is None:
                raise ValueError(f"unrecognized MVSNet checkpoint key: {key}")
            parts = parts[:2] + [sub] + parts[3:]
        leaf = parts[-1]
        name = ".".join(parts)
        if leaf in _PARAMS:
            params[name] = _t(val)
        elif leaf in _STATS:
            stats[name] = _t(val)
        else:
            raise ValueError(f"unrecognized MVSNet checkpoint key: {key}")
    return {"params": params, "batch_stats": stats}


def load_mvsnet_checkpoint(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """A torch .ckpt file: a raw state_dict or {'model' | 'state_dict' |
    'network_state_dict': state_dict}."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    for k in ("model", "state_dict", "network_state_dict"):
        if isinstance(blob, dict) and k in blob:
            blob = blob[k]
            break
    return convert_mvsnet_state_dict(blob)
