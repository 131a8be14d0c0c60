"""Starting a world of ranks, and each rank's slice of the ray batch.

Counterpart of `pointnerf_tpu/parallel/multihost.py` (`initialize`,
`host_batch_slice`, `global_ray_batch`). JAX runs one process per host and
every device of the host inside it; torch.distributed runs one process per
rank. So:

- `initialize()` starts the process group from explicit arguments, else
  from the environment — `MASTER_ADDR` / `MASTER_PORT` / `RANK` /
  `WORLD_SIZE` (torchrun's), then SLURM's `SLURM_PROCID` /
  `SLURM_NTASKS` — and does nothing for a single process, as JAX's
  resolution order does;
- `host_batch_slice` and `global_ray_batch` give a rank its own slice of
  the global batch: with a mesh, its dp row's (the ranks of one row share
  their rays);
- `spawn(fn, world, backend, device)` starts `world` ranks on this machine
  and returns each rank's `fn(*args)`; `World` keeps them up for several
  calls. They rendezvous through a file, not a fixed port, so several
  worlds can run side by side.

The backend is always the caller's: `nccl` needs a card per rank (NCCL
refuses two ranks on one device), `gloo` runs on the CPU and lets ranks
share one card (parallel/collectives.py stages its CUDA tensors through
host memory).
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import DeviceLike, resolve_device
from .mesh import Mesh, rank_device

BACKENDS = ("gloo", "nccl")


def check_backend(backend: Optional[str], device: DeviceLike,
                  world: int) -> torch.device:
    """Refuse a backend the world cannot run, before any process starts:
    nccl needs a card per rank. Never picks another backend."""
    if backend not in BACKENDS:
        raise ValueError(f"name the backend, one of {BACKENDS}: 'nccl' when "
                         "every rank has its own card, 'gloo' on the CPU or "
                         f"for ranks that share a card; got {backend!r}")
    dev = resolve_device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend 'nccl' runs on CUDA devices only; "
                             f"device is {dev}")
        n = torch.cuda.device_count()
        if (dev.index is not None and world > 1) or n < world:
            raise ValueError(
                f"backend 'nccl' refuses two ranks on one device: a world of "
                f"{world} ranks on "
                f"{'device ' + str(dev) if dev.index is not None else str(n) + ' card(s)'}"
                "; give every rank its own card, or pass backend='gloo'")
    return dev


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Start the process group when running several processes. Resolution
    order: explicit arguments -> MASTER_ADDR / RANK / WORLD_SIZE in the
    environment -> SLURM's task variables -> a single process (no-op).
    Returns True if a process group is up. `backend` must be named once
    there is a world to start."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None:
        if "MASTER_ADDR" in env and "RANK" in env and "WORLD_SIZE" in env:
            if int(env["WORLD_SIZE"]) <= 1:
                return False
            init_method = "env://"
            world_size, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        elif ("SLURM_JOB_ID" in env
              and int(env.get("SLURM_NTASKS", "1")) > 1):
            addr = env.get("MASTER_ADDR",
                           env.get("SLURM_LAUNCH_NODE_IPADDR", "localhost"))
            init_method = f"tcp://{addr}:{env.get('MASTER_PORT', '29500')}"
            world_size = int(env["SLURM_NTASKS"])
            rank = int(env["SLURM_PROCID"])
        else:
            return False
    if world_size is None or rank is None:
        raise ValueError("init_method given without world_size and rank")
    if backend not in BACKENDS:
        raise ValueError(f"name the backend, one of {BACKENDS}; got "
                         f"{backend!r}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def _process_count_index():
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def host_batch_slice(global_batch_size: int,
                     mesh: Optional[Mesh] = None) -> slice:
    """This rank's contiguous slice of the global ray batch (the
    DistributedSampler analog): its dp row's with a mesh, else its
    process's."""
    n, i = ((mesh.dp, mesh.d) if mesh is not None
            else _process_count_index())
    per = global_batch_size // n
    return slice(per * i, per * (i + 1))


def global_ray_batch(mesh: Mesh, local_arrays: Dict[str, Any]
                     ) -> Dict[str, torch.Tensor]:
    """This rank's arrays (its slice of the global batch, as
    `host_batch_slice` gives it) as tensors on the mesh's device. The
    global batch is the dp rows' slices in row order; each rank holds its
    own."""
    return {k: torch.as_tensor(np.asarray(v)).to(mesh.device)
            for k, v in local_arrays.items()}


def _serve(rank: int, world: int, backend: str, device: str,
           init_file: str, timeout_s: float, inbox, outbox) -> None:
    """A rank's loop: start the process group, then run each job
    (fn, args) from `inbox` and send (rank, ok, result or traceback) to
    `outbox`, until a None job."""
    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    except BaseException:
        outbox.put((rank, False, traceback.format_exc()))
        return
    try:
        while True:
            job = inbox.get()
            if job is None:
                break
            fn, args = job
            try:
                outbox.put((rank, True, fn(*args)))
            except BaseException:
                outbox.put((rank, False, traceback.format_exc()))
                break
    finally:
        dist.destroy_process_group()


class World:
    """`world` ranks on this machine, up until `close()`. `run(fn, *args)`
    calls fn(*args) on every rank (the process group initialized; a rank
    reads its place with `dist.get_rank()` or `parallel.make_mesh`) and
    returns the results in rank order; `submit(fn, *args)` starts the same
    and `results()` waits for it, so that the caller can work meanwhile.
    fn and its arguments and results are pickled (fn by import path). A
    rank that raises ends the world: `results` raises with its traceback.
    Use as a context manager."""

    def __init__(self, world: int, backend: str, device: DeviceLike = None,
                 timeout_s: float = 600.0):
        check_backend(backend, device, world)
        self.world, self.backend = world, backend
        self.timeout_s = timeout_s
        self._pending = False
        self._dir = tempfile.mkdtemp(prefix="pointnerf_world_")
        ctx = torch.multiprocessing.get_context("spawn")
        self._outbox = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(world)]
        dev = "cpu" if resolve_device(device).type == "cpu" else str(
            device or "cuda")
        self._procs = [ctx.Process(
            target=_serve, daemon=True,
            args=(r, world, backend, dev,
                  os.path.join(self._dir, "rendezvous"), timeout_s,
                  self._inboxes[r], self._outbox))
            for r in range(world)]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, *args) -> List[Any]:
        self.submit(fn, *args)
        return self.results()

    def submit(self, fn: Callable, *args) -> None:
        if not self._procs:
            raise RuntimeError("this world is closed")
        if self._pending:                # a job nobody waited for
            self.results()
        for box in self._inboxes:
            box.put((fn, args))
        self._pending = True

    def results(self) -> List[Any]:
        if not self._pending:
            raise RuntimeError("no job was submitted")
        self._pending = False
        results: Dict[int, Any] = {}
        waited = 0.0
        while len(results) < self.world:
            try:
                rank, ok, res = self._outbox.get(timeout=1.0)
            except queue.Empty:
                waited += 1.0
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive() and r not in results]
                if dead or waited > self.timeout_s:
                    self.close(force=True)
                    raise RuntimeError(
                        f"rank(s) {dead} of the world ended without a result"
                        if dead else
                        f"no result from every rank in {self.timeout_s} s")
                continue
            if not ok:
                self.close(force=True)
                raise RuntimeError(f"rank {rank} failed:\n{res}")
            results[rank] = res
        return [results[r] for r in range(self.world)]

    def close(self, force: bool = False) -> None:
        """Stop the ranks (at once with `force`) and remove the rendezvous
        directory."""
        if not self._procs:
            return
        if not force:
            for box in self._inboxes:
                box.put(None)
            for p in self._procs:
                p.join(timeout=30.0)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
        self._procs = []
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close(force=exc[0] is not None)


def spawn(fn: Callable, world: int, backend: str, device: DeviceLike = None,
          args: Sequence = (), timeout_s: float = 600.0) -> List[Any]:
    """Start `world` ranks with `backend` (on the card unless
    `device="cpu"`; a bare "cuda" spreads the ranks over the cards,
    `mesh.rank_device`), run fn(*args) on each and return the results in
    rank order; a rank that raises raises here."""
    with World(world, backend, device, timeout_s) as w:
        return w.run(fn, *args)
