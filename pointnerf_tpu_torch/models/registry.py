"""Model registry: the reference's `create_model` names mapped onto the
port's trainers.

Counterpart of `pointnerf_tpu/models/registry.py`, with the same four
names and fields; each entry names the port's module (and driver entry
point) that realizes that model family.
"""
from __future__ import annotations

from typing import Any, Dict

MODEL_REGISTRY: Dict[str, Dict[str, Any]] = {}


def register_model(name: str, **entry):
    MODEL_REGISTRY[name] = entry


def create_model(name: str) -> Dict[str, Any]:
    """Resolve a reference model name to the port's implementation entry:
    {'trainer': module path, ['driver': module:function,] 'notes': ...}."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"model '{name}' not registered; "
                       f"have {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


register_model(
    "neural_points_volumetric",
    trainer="pointnerf_tpu_torch.train.step",
    driver="pointnerf_tpu_torch.train.driver:train_scene",
    notes="per-scene optimization on a fixed/maintained point cloud "
          "(reference models/neural_points_volumetric_model_ori.py)")

register_model(
    "mvs_points_volumetric",
    trainer="pointnerf_tpu_torch.train.feedforward",
    driver="pointnerf_tpu_torch.train.driver:train_dataset_scene",
    notes="mode 0 (feed-forward MVS->points->render, run/train.py) via "
          "train/feedforward.py; mode 2 (per-scene with MVS init) via "
          "mvs/points_init.py gen_scene_points + train_scene")

register_model(
    "neural_points_volumetric_multi",
    trainer="pointnerf_tpu_torch.train.neural2d",
    notes="feature rendering + CNN neural-render head "
          "(fork models/neural_points_volumetric_multi_model.py)")

register_model(
    "neural_points_volumetric_multiseq",
    trainer="pointnerf_tpu_torch.train.neural2d",
    notes="multi-sequence point clouds + StyleGAN2 head with per-frame "
          "style codes; sequences map to the mp point-shard axis "
          "(data/waymo.load_multiseq, parallel/sharded."
          "partition_points_multiseq; the sharded step, "
          "make_sharded_neural2d_step, takes the CNN head, as JAX's does) "
          "(fork train_ddp.py)")
