"""Tracing and profiling on torch.profiler.

Counterpart of `pointnerf_tpu/utils/profiling.py` (`device_trace`,
`annotate`, `StepTimer`): a device trace of a block (host and CUDA
activities, written as a Chrome trace that Perfetto or chrome://tracing
open), named ranges that show in that trace, and a host-side timer whose
sections wait for the device at both ends, as the JAX version blocks on its
results.

    with device_trace("runs/x/trace") as prof:
        with annotate("request"):
            out = eval_step(params, st, grid, batch, cfg)
    prof.key_averages()          # the per-kernel device times
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


def _sync(device: Optional[torch.device]) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def device_trace(logdir: str, name: str = "trace") -> Iterator:
    """Profile the block (CPU, and CUDA when a card is present) and write
    `<logdir>/<name>.pt.trace.json`. Yields the torch.profiler.profile, so
    the caller can read `key_averages()` after the block."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"{name}.pt.trace.json"))


def annotate(name: str):
    """A named range in the profiler's timeline."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Host-side wall-clock accumulator; each section waits for `device`
    before it starts and before it stops, so the time covers the device
    work launched inside it.

    timer = StepTimer(torch.device("cuda"))
    with timer.section("query"): out = f()
    timer.report() -> {"query": {"mean_ms": ..., "total_s": ..., "count": ...}}
    """

    def __init__(self, device: Optional[torch.device] = None):
        self.device = None if device is None else torch.device(device)
        self._acc: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def section(self, name: str):
        _sync(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(self.device)
            self._acc[name].append(time.perf_counter() - t0)

    def time_fn(self, name: str, fn, *args, **kw):
        with self.section(name):
            return fn(*args, **kw)

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: {"mean_ms": 1000.0 * sum(v) / len(v), "total_s": sum(v),
                    "count": len(v)} for k, v in self._acc.items()}

    def reset(self):
        self._acc.clear()
