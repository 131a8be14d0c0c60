"""Checkpoint / resume.

Counterpart of `pointnerf_tpu/train/checkpoint.py` (`save_checkpoint`,
`checkpoint_meta`, `latest_checkpoint`, `load_checkpoint`) with the same
layout: `<root>/ckpt_<step:08d>/` holds the whole TrainState and a
`meta.json` sidecar (`step`, and the caller's `num_active`, `capacity`).
The state is one `torch.save` of a flat dict of tensors keyed by tree path
(`params/mlp/block1/0/w`, `opt_state/points/mu/xyz`, `step`, `hits`, and
`key`, the jitter generator's state), so `torch.load(weights_only=True)`
reads it back. Resume is exact: parameters, every Adam moment and count,
the hit counters, the step and the generator state come back bit for bit.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from .step import TrainState

STATE_FILE = "state.pt"


def _ckpt_dir(root: str, step: int) -> str:
    return os.path.join(os.path.abspath(root), f"ckpt_{step:08d}")


def _flatten(tree, prefix: str, out: Dict[str, torch.Tensor]):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}", out)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            _flatten(v, f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    elif tree is not None:
        out[prefix.lstrip("/")] = tree.detach()
    return out


def _unflatten(template, prefix: str, flat: Dict[str, torch.Tensor]):
    """The template's structure with each leaf taken from `flat`; shapes and
    dtypes must match the template's."""
    if isinstance(template, dict):
        return {k: _unflatten(v, f"{prefix}/{k}", flat)
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*[_unflatten(v, f"{prefix}/{k}", flat)
                                for k, v in zip(template._fields, template)])
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, f"{prefix}/{i}", flat)
                              for i, v in enumerate(template))
    if template is None:
        return None
    key = prefix.lstrip("/")
    if key not in flat:
        raise KeyError(f"checkpoint has no entry {key!r}")
    x = flat[key]
    if x.shape != template.shape or x.dtype != template.dtype:
        raise ValueError(f"checkpoint entry {key!r} is {tuple(x.shape)} "
                         f"{x.dtype}, the template wants "
                         f"{tuple(template.shape)} {template.dtype}")
    return x.to(template.device)


def save_checkpoint(root: str, state: TrainState,
                    meta: Optional[Dict] = None) -> str:
    """Write `<root>/ckpt_<step>/` (state.pt + meta.json)."""
    step = int(state.step)
    path = _ckpt_dir(root, step)
    os.makedirs(path, exist_ok=True)
    flat = _flatten({"params": state.params, "opt_state": state.opt_state,
                     "step": state.step, "hits": state.hits}, "", {})
    flat["key"] = state.key.get_state()
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save({k: v.cpu() for k, v in flat.items()}, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": step, **(meta or {})}, f)
    return path


def checkpoint_meta(path: str) -> Dict[str, Any]:
    """Just the sidecar (to size the restore template before building it:
    the capacity changes when growth re-buckets the cloud)."""
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def latest_checkpoint(root: str) -> Optional[str]:
    cands = sorted(glob.glob(os.path.join(os.path.abspath(root), "ckpt_*")))
    return cands[-1] if cands else None


def load_checkpoint(path: str, template: TrainState
                    ) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore into the template's structure, shapes and devices (the
    capacity must match: build the template at `checkpoint_meta`'s). The
    template's generator takes the saved generator state. A checkpoint
    written without hit counters restores with zero counters."""
    flat = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)
    tree = {"params": template.params, "opt_state": template.opt_state,
            "step": template.step}
    restored = _unflatten(tree, "", flat)
    hits = None
    if template.hits is not None:
        hits = (_unflatten(template.hits, "hits", flat) if "hits" in flat
                else torch.zeros_like(template.hits))
    template.key.set_state(flat["key"])
    state = TrainState(params=restored["params"],
                       opt_state=restored["opt_state"],
                       step=restored["step"], key=template.key, hits=hits)
    return state, checkpoint_meta(path)
