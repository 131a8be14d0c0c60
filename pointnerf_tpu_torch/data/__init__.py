"""Scene data for the PyTorch port (counterpart of `pointnerf_tpu/data/`):
the dataset registry and its loaders. Datasets register by name; items are
dicts of numpy arrays that the drivers turn into ray batches. Every loader
of the JAX package is registered; frames are read as PNG, or as JPEG
through Pillow where a scene ships JPEG (ScanNet, LLFF)."""
from __future__ import annotations

DATASET_REGISTRY = {}


def register_dataset(name):
    def deco(cls):
        DATASET_REGISTRY[name] = cls
        return cls
    return deco


def find_dataset_class_by_name(name: str):
    """The loader class registered as `name`."""
    from . import (dtu, dtu_ft, llff, nerf_synth, nsvf, scannet,  # noqa: F401
                   waymo)
    if name in DATASET_REGISTRY:
        return DATASET_REGISTRY[name]
    raise KeyError(f"dataset '{name}' not registered; "
                   f"have {sorted(DATASET_REGISTRY)}")
