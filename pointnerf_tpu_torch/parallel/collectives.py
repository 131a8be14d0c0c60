"""Collectives over the mesh's axes, with JAX's transposes as backward.

The JAX sharded path (`pointnerf_tpu/parallel/sharded.py`) calls XLA
collectives inside `shard_map`; these are their torch.distributed
counterparts, each the identity on an axis of size 1:

- `all_to_all(x, mesh)`: `lax.all_to_all(x, "mp", split_axis=0,
  concat_axis=2, tiled=True)` (`_a2a`): x [R, S, K, ...] is split into mp
  blocks of rays, block j goes to mp column j, and the blocks received are
  laid side by side on axis 2 in column order: [R / mp, S, mp * K, ...].
  Backward: the reverse all_to_all, so each point shard receives the
  cotangents of the candidates it sent.
- `all_gather(x, mesh, axes, dim)`: the tiled `lax.all_gather`; blocks in
  rank order of the axis. Backward: the cotangents summed over the axis,
  each rank keeping its own block (the transpose `psum_scatter`).
- `psum` / `pmean` / `pmax` over "dp", "mp" or ("dp", "mp"), and
  `pmean_tree` for a tree of tensors in one reduction. These act on values
  outside autograd (gradients, losses, counts).

The backend is the caller's choice, made when the world starts
(`multihost.initialize` / `spawn`): `nccl` when every rank has its own
card, `gloo` on the CPU and for ranks that share one card (NCCL refuses
two ranks on one device). This module never changes it. gloo's support for
CUDA tensors differs between collectives and builds, so under gloo every
collective copies a CUDA tensor to host memory, runs there, and copies the
result back to the card; the computation around it stays on the card.
Each collective adds its bytes and host seconds to `mesh.comm`.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List

import torch
import torch.distributed as dist

from ..train.optim import tree_leaves, tree_map
from .mesh import Axes, Mesh


def _staged(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The tensor a collective of this world takes: a host copy of a CUDA
    tensor under gloo (see the module docstring), else x itself."""
    x = x.contiguous()
    if x.is_cuda and mesh.backend == "gloo":
        return x.cpu()
    return x


def _wire(x: torch.Tensor) -> torch.Tensor:
    """bool travels as uint8 (not every backend reduces or moves bool)."""
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def _a2a_raw(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """all_to_all_single over the mp row: x [n * B, ...] -> [n * B, ...],
    block j received from column j."""
    t0 = time.perf_counter()
    src = _staged(mesh, _wire(x))
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group("mp"))
    out = out.to(x.device).to(x.dtype)
    mesh.comm.add("all_to_all", src.nbytes, time.perf_counter() - t0)
    return out


def _gather_raw(mesh: Mesh, x: torch.Tensor, axes: Axes) -> List[torch.Tensor]:
    t0 = time.perf_counter()
    src = _staged(mesh, _wire(x))
    parts = [torch.empty_like(src) for _ in range(mesh.axis_size(axes))]
    dist.all_gather(parts, src, group=mesh.group(axes))
    parts = [p.to(x.device).to(x.dtype) for p in parts]
    mesh.comm.add("all_gather", src.nbytes, time.perf_counter() - t0)
    return parts


def _reduce_raw(mesh: Mesh, x: torch.Tensor, axes: Axes,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    t0 = time.perf_counter()
    src = _staged(mesh, x)
    if src is x:
        src = x.clone()
    dist.all_reduce(src, op=op, group=mesh.group(axes))
    out = src.to(x.device)
    mesh.comm.add("all_reduce", src.nbytes, time.perf_counter() - t0)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        n = mesh.mp
        R = x.shape[0]
        if R % n:
            raise ValueError(f"all_to_all: {R} rows do not split over mp={n}")
        y = _a2a_raw(mesh, x)                       # [n * R/n, S, K, ...]
        y = y.reshape((n, R // n) + tuple(x.shape[1:]))
        # [R/n, S, n, K, ...] -> [R/n, S, n * K, ...]
        y = y.movedim(0, 2)
        return y.reshape((R // n, x.shape[1], n * x.shape[2])
                         + tuple(x.shape[3:]))

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        n = mesh.mp
        Rb, S, nK = g.shape[:3]
        g = g.reshape((Rb, S, n, nK // n) + tuple(g.shape[3:]))
        g = g.movedim(2, 0).reshape((n * Rb, S, nK // n) + tuple(g.shape[4:]))
        return _a2a_raw(mesh, g), None


def all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """JAX's tiled all_to_all over "mp" (split axis 0, concat axis 2);
    differentiable. x [R, S, K, ...] -> [R / mp, S, mp * K, ...]."""
    if mesh.mp == 1:
        return x
    return _AllToAll.apply(x, mesh)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        ctx.n = x.shape[dim]
        return torch.cat(_gather_raw(mesh, x, axes), dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.mesh, ctx.axes, ctx.dim
        total = _reduce_raw(mesh, g.contiguous(), axes)
        idx = dist.get_rank(mesh.group(axes))
        return total.narrow(dim, idx * ctx.n, ctx.n), None, None, None


def all_gather(x: torch.Tensor, mesh: Mesh, axes: Axes = "mp",
               dim: int = 0) -> torch.Tensor:
    """JAX's tiled all_gather over `axes`: the ranks' blocks concatenated
    on `dim` in the axis's rank order (over ("dp", "mp"), global rank
    d * mp + m); differentiable (backward: the cotangents summed over the
    axis, each rank's own block)."""
    if mesh.axis_size(axes) == 1:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _AllGather.apply(x, mesh, axes, dim)
    return torch.cat(_gather_raw(mesh, x, axes), dim)


def psum(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    """Sum over `axes` (outside autograd)."""
    if mesh.axis_size(axes) == 1:
        return x
    return _reduce_raw(mesh, x.detach(), axes)


def pmax(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    """Maximum over `axes` (outside autograd)."""
    if mesh.axis_size(axes) == 1:
        return x
    return _reduce_raw(mesh, x.detach(), axes, op=dist.ReduceOp.MAX)


def pmean(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    """Mean over `axes` (outside autograd): the sum, then / axis size."""
    n = mesh.axis_size(axes)
    return x if n == 1 else psum(x, mesh, axes) / n


def psum_tree(tree: Any, mesh: Mesh, axes: Axes) -> Any:
    """`psum` of every float leaf of a tree in one reduction (the leaves
    packed into one flat buffer)."""
    if mesh.axis_size(axes) == 1:
        return tree
    leaves = tree_leaves(tree)
    flat = torch.cat([t.detach().reshape(-1).float() for t in leaves])
    total = psum(flat, mesh, axes)
    out, off = [], 0
    for t in leaves:
        out.append(total[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    it = iter(out)
    return tree_map(lambda _t: next(it), tree)


def pmean_tree(tree: Any, mesh: Mesh, axes: Axes) -> Any:
    """`pmean` of every leaf of a tree, in one reduction."""
    n = mesh.axis_size(axes)
    if n == 1:
        return tree
    return tree_map(lambda t: t / n, psum_tree(tree, mesh, axes))


def pmean_items(items: Dict[str, torch.Tensor], mesh: Mesh,
                axes: Axes) -> Dict[str, torch.Tensor]:
    """`pmean` of a dict of scalars (float32), in one reduction."""
    keys = list(items)
    vals = pmean_tree([items[k].float() for k in keys], mesh, axes)
    return dict(zip(keys, vals))


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the mesh."""
    if mesh.size > 1:
        dist.barrier(group=mesh.group(("dp", "mp")))
