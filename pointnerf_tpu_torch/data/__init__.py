"""Scene data for the PyTorch port (counterpart of `pointnerf_tpu/data/`):
the dataset registry and its loaders. Datasets register by name; items are
dicts of numpy arrays that the drivers turn into ray batches."""
from __future__ import annotations

from .. import not_ported

DATASET_REGISTRY = {}
# registered by the JAX package, not ported yet (ROADMAP Queue 1, datasets:
# JPEG)
NOT_PORTED = ("llff_ft", "scannet_ft")


def register_dataset(name):
    def deco(cls):
        DATASET_REGISTRY[name] = cls
        return cls
    return deco


def find_dataset_class_by_name(name: str):
    """The loader class registered as `name`."""
    from . import dtu, dtu_ft, nerf_synth, nsvf, waymo  # noqa: F401
    if name in DATASET_REGISTRY:
        return DATASET_REGISTRY[name]
    if name in NOT_PORTED:
        raise not_ported(f"the {name!r} dataset", "Queue 1, datasets")
    raise KeyError(f"dataset '{name}' not registered; "
                   f"have {sorted(DATASET_REGISTRY)}")
