#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package (orbax) into the PyTorch port's.

    python scripts/orbax_to_port.py RUN/ckpt_00001000 --out PORT_RUN \
        [--config RUN/opt.json] [--device cuda|cpu]

The JAX package's `train/checkpoint.save_checkpoint` writes
`<run>/ckpt_<step>/` (an orbax tree of the whole TrainState and a
`meta.json` with the cloud's `num_active` and `capacity`); its drivers
write the run's config as `<run>/opt.json`. This script restores that state
against a template built from the config at the meta's capacity, carries it
across with `pointnerf_tpu_torch.convert.train_state_from_jax` (the MLP and
point parameters, both Adam groups' moments and counts, the step, the hit
counters) and writes the port's `<out>/ckpt_<step>/state.pt` and
`meta.json` (`pointnerf_tpu_torch/train/checkpoint.py`), with the config as
`<out>/opt.json`. The port's `train_scene(..., resume=True)` with that
config and `run_dir=<out>` resumes from it.

The JAX PRNG key cannot carry over. In its place the checkpoint holds the
state of a fresh jitter generator seeded from cfg.train.seed as the port's
drivers seed theirs (seed + 2), for the device the port run resumes on
(`--device`, default cuda: a CUDA generator's state differs in kind from a
CPU one's). The resumed run's jitter draws are therefore not the JAX run's.

This imports JAX and orbax, so it runs where they are installed (the CPU is
enough; JAX_PLATFORMS defaults to cpu here). The port itself never imports
JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class _SavedGenerator:
    """Stands in for the resuming device's generator: `save_checkpoint`
    reads only its state."""

    def __init__(self, state):
        self.state = state

    def get_state(self):
        return self.state


def seeded_generator_state(seed: int, device: str = "cuda"):
    """The state of `torch.Generator(device=device).manual_seed(seed)`. The
    CUDA one is built from its layout, so that a host without CUDA writes
    it: the Philox generator keeps its seed (uint64) and its offset (int64,
    0 after manual_seed), little-endian."""
    import numpy as np
    import torch
    if device == "cpu":
        return torch.Generator().manual_seed(seed).get_state()
    return torch.from_numpy(np.array([seed, 0], "<u8").view(np.uint8).copy())


def convert_checkpoint(ckpt_dir: str, out_root: str,
                       config_path: str = None, device: str = "cuda") -> str:
    """Convert JAX's `ckpt_dir` into the port's checkpoint under `out_root`.
    The config is `config_path`, or opt.json beside `ckpt_dir`; the
    generator state is that of cfg.train.seed + 2 on `device`. Returns the
    port's checkpoint directory."""
    import jax
    import numpy as np

    from pointnerf_tpu.config import PointNeRFConfig
    from pointnerf_tpu.models.points import make_point_cloud
    from pointnerf_tpu.train.checkpoint import checkpoint_meta, load_checkpoint
    from pointnerf_tpu.train.driver import init_mlp_params
    from pointnerf_tpu.train.step import create_train_state
    from pointnerf_tpu_torch.convert import train_state_from_jax
    from pointnerf_tpu_torch.train.checkpoint import save_checkpoint

    ckpt_dir = os.path.abspath(ckpt_dir)
    if config_path is None:
        config_path = os.path.join(os.path.dirname(ckpt_dir), "opt.json")
    with open(config_path) as f:
        cfg_json = f.read()
    cfg = PointNeRFConfig.from_json(cfg_json)
    meta = checkpoint_meta(ckpt_dir)
    if "capacity" not in meta:
        raise SystemExit(f"{ckpt_dir}/meta.json has no capacity")
    cap = int(meta["capacity"])
    key = jax.random.PRNGKey(0)
    pc, _st = make_point_cloud(np.zeros((cap, 3), np.float32), key,
                               cfg.points, cfg.agg.point_features_dim,
                               capacity=cap)
    template = create_train_state(key, init_mlp_params(key, cfg), pc, cfg)
    state, meta = load_checkpoint(ckpt_dir, template)
    key = _SavedGenerator(seeded_generator_state(cfg.train.seed + 2, device))
    port = train_state_from_jax(jax.tree.map(np.asarray, state), key,
                                device="cpu")
    os.makedirs(out_root, exist_ok=True)
    path = save_checkpoint(out_root, port, {k: v for k, v in meta.items()
                                            if k != "step"})
    with open(os.path.join(out_root, "opt.json"), "w") as f:
        f.write(cfg_json)
    return path


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ckpt", help="the JAX package's ckpt_<step> directory")
    ap.add_argument("--out", required=True,
                    help="the port's run directory to write into")
    ap.add_argument("--config", default=None,
                    help="the run's opt.json (default: beside the ckpt)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the device the port run resumes on")
    args = ap.parse_args()
    path = convert_checkpoint(args.ckpt, args.out, args.config, args.device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    print(f"wrote {path} (step {meta['step']}, num_active "
          f"{meta.get('num_active')}, capacity {meta.get('capacity')}); "
          "the JAX PRNG key does not carry over: the checkpoint holds a "
          f"{args.device} generator seeded from cfg.train.seed + 2")


if __name__ == "__main__":
    main()
