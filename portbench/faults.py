"""Faults planted underneath the timed path, for the check's own tests and
for the readings its limits are set from. Each one is a context manager
that replaces one of the program's entry points for the block:

- `frozen_state`: a training step that returns its state unchanged;
- `half_batch`: a training step that leaves out half of its batch and
  takes the mean over the rest;
- `altered_answer`: one chunk of each rendered frame comes back with its
  colors altered where they are produced.
"""
from __future__ import annotations

import contextlib
import importlib
from typing import Callable


@contextlib.contextmanager
def _replaced(module: str, attr: str, make: Callable):
    mod = importlib.import_module(module)
    real = getattr(mod, attr)
    setattr(mod, attr, make(real))
    try:
        yield
    finally:
        setattr(mod, attr, real)


def frozen_state():
    def make(real):
        def step(state, st, grid, batch, cfg, **kw):
            _new, items = real(state, st, grid, batch, cfg, **kw)
            return state, items
        return step
    return _replaced("pointnerf_tpu_torch.train.step", "train_step", make)


def half_batch():
    def make(real):
        def step(state, st, grid, batch, cfg, **kw):
            h = batch.raydir.shape[0] // 2
            batch = batch._replace(raydir=batch.raydir[:h],
                                   pixel_idx=batch.pixel_idx[:h],
                                   gt_image=batch.gt_image[:h])
            return real(state, st, grid, batch, cfg, **kw)
        return step
    return _replaced("pointnerf_tpu_torch.train.step", "train_step", make)


def altered_answer(n_chunks: int, by: float = 0.05):
    """The colors of chunk n_chunks // 2 of every frame moved by `by`."""
    seen = [0]

    def make(real):
        def eval_step(*a, **kw):
            out = real(*a, **kw)
            i = seen[0] % n_chunks
            seen[0] += 1
            if i == n_chunks // 2:
                out = out._replace(coarse_raycolor=out.coarse_raycolor + by)
            return out
        return eval_step
    return _replaced("pointnerf_tpu_torch.train.grow", "eval_step", make)


def replay_half_batch(cell):
    """The program's check numbers of the cell's first steps driven again
    from the same initial state and jitter seed, with half of each batch
    left out."""
    import torch
    from pointnerf_tpu_torch.train.step import create_train_state
    saved = (cell.state, cell.kept, cell.losses, cell.units)
    key = torch.Generator(device=cell.dev).manual_seed(cell.key_seed)
    cell.state = create_train_state(key, cell.mlp0, cell.pc, cell.cfg)
    cell.kept, cell.losses, cell.units = {}, [], 0
    n = cell.traffic["checked_steps"]
    with half_batch():
        for i in range(n):
            cell.unit()
            if i + 1 in (1, n):
                cell.kept[i + 1] = cell.state
    out = cell.program_train_readings()
    cell.state, cell.kept, cell.losses, cell.units = saved
    return out
