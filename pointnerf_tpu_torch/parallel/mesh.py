"""The (dp, mp) mesh over a torch.distributed world.

Counterpart of `pointnerf_tpu/parallel/mesh.py` (`make_mesh`). The JAX mesh
is a grid of devices with two named axes; here each rank of the world is
one cell of that grid, in JAX's device order (`reshape(dp, mp)`): rank r
sits at dp row r // mp and mp column r % mp.

  dp — rays: pure data parallelism, gradients averaged over the rows.
  mp — neural points: the cloud, its grids and its Adam moments are split
       over mp; the KNN candidates are exchanged with one all_to_all
       (parallel/sharded.py).

A mesh holds the rank's coordinates and three process groups: the world
(the ranks of the mesh), the rank's mp row (the ranks of its dp row, which
share its rays and hold the other point shards) and its dp column (the
ranks that hold the same point shard). Collectives over them are in
`parallel/collectives.py`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

from .. import DeviceLike, resolve_device

Axes = Union[str, Tuple[str, ...]]


class CommStats:
    """What a rank's collectives cost, by kind ("all_to_all", "all_gather",
    "all_reduce"): calls, bytes this rank handed to the collective, and
    host seconds around it. Under gloo on a card the seconds include the
    staging copies to and from host memory, which wait for the card; under
    nccl a call returns once it is queued on the card, so they do not
    measure the transfer."""

    def __init__(self):
        self.by_kind: Dict[str, list] = {}

    def reset(self) -> None:
        self.by_kind = {}

    def add(self, kind: str, nbytes: int, seconds: float) -> None:
        c = self.by_kind.setdefault(kind, [0, 0, 0.0])
        c[0] += 1
        c[1] += nbytes
        c[2] += seconds

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {k: {"calls": c[0], "bytes": c[1], "seconds": c[2]}
                for k, c in self.by_kind.items()}


class Mesh:
    """One rank's view of a (dp, mp) mesh: its coordinates (`d`, `m`), its
    device, the backend of the world, the process groups of its axes (None
    where the axis has size 1: every collective over it is the identity)
    and the cost of its collectives so far (`comm`, a CommStats)."""

    def __init__(self, dp: int, mp: int, rank: int, device: torch.device,
                 backend: Optional[str], world_group=None, mp_group=None,
                 dp_group=None):
        self.dp, self.mp = dp, mp
        self.rank = rank
        self.d, self.m = rank // mp, rank % mp
        self.device = device
        self.backend = backend
        self._groups = {("dp", "mp"): world_group, ("mp",): mp_group,
                        ("dp",): dp_group}
        self.comm = CommStats()

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "mp": self.mp}

    @property
    def size(self) -> int:
        return self.dp * self.mp

    @staticmethod
    def axes(axes: Axes) -> Tuple[str, ...]:
        t = (axes,) if isinstance(axes, str) else tuple(axes)
        if t not in (("dp",), ("mp",), ("dp", "mp")):
            raise ValueError(f"mesh axes must be 'dp', 'mp' or ('dp', 'mp'),"
                             f" got {axes!r}")
        return t

    def axis_size(self, axes: Axes) -> int:
        t = self.axes(axes)
        return (self.dp if "dp" in t else 1) * (self.mp if "mp" in t else 1)

    def group(self, axes: Axes):
        return self._groups[self.axes(axes)]

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.dp}, mp={self.mp}, rank={self.rank}, "
                f"d={self.d}, m={self.m}, device={self.device}, "
                f"backend={self.backend})")


def rank_device(device: DeviceLike, rank: int) -> torch.device:
    """The device of `rank`: `device` itself when it names an index or the
    CPU; a bare "cuda" is card rank % device_count, so ranks spread over the
    host's cards and share them when there are fewer cards than ranks."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def make_mesh(dp: int, mp: int = 1, device: DeviceLike = None
              ) -> Optional[Mesh]:
    """A (dp, mp) mesh over the first dp * mp ranks of the world, on the
    card unless `device="cpu"` (a bare "cuda" resolves per rank,
    `rank_device`). Every rank of the world calls it: the process groups are
    created collectively. Ranks past dp * mp get None, as the JAX mesh
    leaves the devices past dp * mp out. Without a process group a 1 x 1
    mesh is the single process; a larger one raises."""
    resolve_device(device)
    if dp < 1 or mp < 1:
        raise ValueError(f"mesh {dp}x{mp}: both axes must be >= 1")
    n = dp * mp
    if not dist.is_initialized():
        if n == 1:
            return Mesh(1, 1, 0, rank_device(device, 0), None)
        raise RuntimeError(f"mesh {dp}x{mp} needs a process group of {n} "
                           "ranks: start one first (parallel.multihost."
                           "initialize or spawn)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n > world:
        raise ValueError(f"mesh {dp}x{mp} needs {n} ranks, have {world}")
    world_group = (dist.group.WORLD if n == world
                   else dist.new_group(list(range(n))))
    mp_group = dp_group = None
    # new_group is collective over the whole world: every rank creates
    # every group, in the same order
    if mp > 1:
        for d in range(dp):
            g = dist.new_group([d * mp + m for m in range(mp)])
            if rank // mp == d:
                mp_group = g
    if dp > 1:
        for m in range(mp):
            g = dist.new_group([d * mp + m for d in range(dp)])
            if rank % mp == m:
                dp_group = g
    if rank >= n:
        return None
    return Mesh(dp, mp, rank, rank_device(device, rank), dist.get_backend(),
                world_group=world_group if n > 1 else None,
                mp_group=mp_group, dp_group=dp_group)
