"""Inference step and grid refresh.

Counterpart of `pointnerf_tpu/train/step.py:136-206` (`eval_step`,
`refresh_grid`). The training step, losses and optimizer come with the
training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..config import PointNeRFConfig
from ..models.points import PointCloud, PointCloudStatic
from ..models.renderer import RayBatch, RenderOutput, render_rays
from ..ops.grid import PointGrid, build_grid


@torch.inference_mode()
def eval_step(params, st: PointCloudStatic, grid: PointGrid, batch: RayBatch,
              cfg: PointNeRFConfig, prob: bool = False) -> RenderOutput:
    """Inference forward (no jitter, no grad). params = {"mlp": aggregator
    params, "points": PointCloud}; everything on one device."""
    return render_rays(params["mlp"], params["points"], st, grid, batch, cfg,
                       train=False, prob=prob)


def refresh_grid(pc: PointCloud, st: PointCloudStatic, cfg: PointNeRFConfig,
                 max_d: Optional[int] = None) -> Tuple[PointGrid, int]:
    """Rebuild the occupancy grid and neighbor tables after a point-set
    change. Returns (grid, max_d).

    Truncation guard: when the true dilated-occupied cell count exceeds the
    table capacity, the grid is rebuilt with max_d auto-sized to 1.25x that
    count (rounded up to 4096) — never silently truncated. The max_d used is
    handed back; pass it as `max_d` to later refreshes so they build once
    (the JAX version rebuilds twice on every refresh past the envelope)."""
    q = cfg.query if max_d is None else dataclasses.replace(cfg.query,
                                                            max_d=max_d)
    grid = build_grid(pc.xyz, st.num_active, q)
    nd = int(grid.num_dil)
    caps = [grid.occ_vids.shape[0]]
    if grid.nbr_pid is not None:
        caps.append(grid.nbr_pid.shape[0])
    if nd > min(caps):
        new_max_d = -(-int(nd * 1.25) // 4096) * 4096
        print(f"[grid] {nd} dilated-occupied cells exceed the table "
              f"envelope {min(caps)}; rebuilding with max_d={new_max_d}")
        q = dataclasses.replace(q, max_d=new_max_d)
        grid = build_grid(pc.xyz, st.num_active, q)
    return grid, q.max_d
