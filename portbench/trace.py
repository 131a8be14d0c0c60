"""The traced stretch: counting wrappers around the program's kernel entry
points, named ranges around each call into a layer, and the reduction of
the profiler's trace to kernel time by name, the device's busy time and the
idle gaps by what the host was doing.

The busy time is the union of the kernel intervals over the stretch's
synchronized host window, as `scripts/port_profile.py::profiled` computes it
(commit 9ce5b3a; a frozen copy of that arithmetic).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

# the ranges the stretch puts around calls into the program's layers:
# (module path, attribute, range name). Each attribute is looked up by the
# program at call time, so replacing it routes every call through the range.
LAYER_SPOTS = (
    ("pointnerf_tpu_torch.train.step", "loss_and_grads", "step.loss_and_grads"),
    ("pointnerf_tpu_torch.train.step", "alternated_update", "optim.adam"),
    ("pointnerf_tpu_torch.train.step", "compute_losses", "losses"),
    ("pointnerf_tpu_torch.train.grow", "eval_step", "step.eval_step"),
    ("pointnerf_tpu_torch.models.renderer", "query_points", "query.query_points"),
    ("pointnerf_tpu_torch.models.renderer", "gather_points", "points.gather"),
    ("pointnerf_tpu_torch.models.renderer", "aggregate", "aggregator"),
    ("pointnerf_tpu_torch.models.renderer", "ray_march", "march.plain"),
    ("pointnerf_tpu_torch.models.renderer", "fused_march", "k2.fused_march"),
    ("pointnerf_tpu_torch.ops.query", "knn_select", "k1.knn_select"),
    ("pointnerf_tpu_torch.models.aggregator", "fused_decode", "k3.fused_decode"),
    ("pointnerf_tpu_torch.ops.fused_decode", "fused_decode_bwd",
     "k4.fused_decode_bwd"),
)


class Calls:
    """What the counting wrappers saw in the stretch: each kernel call's
    inputs or shapes, as the metric readers need them. Device scalars are
    kept as tensors and read once the stretch is over."""

    def __init__(self):
        self.k1: List[Tuple] = []     # (nbr_xyz, dslot, ok, pid, K)
        self.k3: List[Dict] = []      # {"M", "rows", "live", "widths", "grad"}
        self.k2: List[Tuple] = []     # (R, SR, C)

    def resolve(self):
        for c in self.k3:
            for key in ("rows", "live"):
                c[key] = int(c[key])


def _counting(name: str, real, calls: Calls):
    """`real` wrapped so that each call is recorded in `calls`."""
    from .counting import widths_of
    if name == "k1.knn_select":
        def wrap(nbr_xyz, nbr_pid, dslot, centers, ok, K, r2):
            pid, d2 = real(nbr_xyz, nbr_pid, dslot, centers, ok, K=K, r2=r2)
            calls.k1.append((nbr_xyz, dslot, ok, pid, K))
            return pid, d2
        return wrap
    if name == "k3.fused_decode":
        def wrap(feat, dists, extras, w, params, spec):
            nz = (w[:, 0] != 0)
            grad = torch.is_grad_enabled() and any(
                t.requires_grad for t in [feat, dists, extras, w])
            calls.k3.append({"M": w.shape[0], "rows": nz.sum(),
                             "live": nz.view(-1, spec.K).any(1).sum(),
                             "widths": widths_of(spec), "grad": grad})
            return real(feat, dists, extras, w, params, spec)
        return wrap
    if name == "k2.fused_march":
        def wrap(dist, valid, feats, bg):
            calls.k2.append((dist.shape[0], dist.shape[1],
                             feats.shape[-1] - 1))
            return real(dist, valid, feats, bg)
        return wrap
    return real


@contextlib.contextmanager
def instrumented(calls: Calls):
    """Every LAYER_SPOTS attribute replaced by its range (and, for the
    kernels, its counting wrapper) for the block; restored after."""
    import importlib
    saved = []
    for mod_name, attr, name in LAYER_SPOTS:
        mod = importlib.import_module(mod_name)
        real = getattr(mod, attr)
        inner = _counting(name, real, calls)

        def ranged(*a, _inner=inner, _name=name, **k):
            with torch.profiler.record_function(_name):
                return _inner(*a, **k)
        # the program keeps launch counters on some entry points
        ranged.__dict__.update(real.__dict__)
        saved.append((mod, attr, real))
        setattr(mod, attr, ranged)
    try:
        yield
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)


class Trace:
    """The stretch reduced: kernel seconds by name, busy and window seconds,
    and the idle gaps' seconds by the innermost host range around them."""

    def __init__(self, kernels: Dict[str, List[float]], busy_s: float,
                 window_s: float, gaps: Dict[str, float]):
        self.kernels = kernels          # name -> [calls, seconds]
        self.busy_s = busy_s
        self.window_s = window_s
        self.gaps = gaps

    def seconds(self, keys) -> float:
        """Device seconds of the kernels whose name holds any of `keys`."""
        return sum(v[1] for k, v in self.kernels.items()
                   if any(key in k for key in keys))

    def kernel_total(self) -> float:
        return sum(v[1] for v in self.kernels.values())

    def breakdown(self, n: int = 10) -> Dict[str, List]:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:n]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v[1]] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def merge_intervals(intervals) -> List[List[float]]:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    if not intervals:
        return []
    intervals = sorted(intervals)
    merged = [list(intervals[0])]
    for s, t in intervals[1:]:
        if s > merged[-1][1]:
            merged.append([s, t])
        else:
            merged[-1][1] = max(merged[-1][1], t)
    return merged


def reduce_events(events, window_s: float, range_names) -> Trace:
    """Reduce a profiler's events (FunctionEvent-like: name, device_type,
    time_range.start / end in microseconds)."""
    cuda = torch.autograd.DeviceType.CUDA
    intervals, per = [], defaultdict(lambda: [0, 0.0])
    ranges = []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.name in range_names:
            # a host range (the profiler mirrors it on the device's
            # timeline too; that copy is no device work)
            if e.device_type != cuda:
                ranges.append((s, t, e.name))
        elif e.device_type == cuda:
            intervals.append((s, t))
            k = per[e.name]
            k[0] += 1
            k[1] += (t - s) / 1e6
    if not intervals:
        return Trace({}, 0.0, window_s, {})
    merged = merge_intervals(intervals)
    busy = sum(t - s for s, t in merged) / 1e6
    # a sweep over the gaps in time order: the ranges open at a gap's
    # midpoint, the innermost (shortest) one names it
    gaps: Dict[str, float] = defaultdict(float)
    ranges.sort()
    active, nxt = [], 0
    for (_s0, e0), (s1, _e1) in zip(merged[:-1], merged[1:]):
        mid = 0.5 * (e0 + s1)
        while nxt < len(ranges) and ranges[nxt][0] <= mid:
            active.append(ranges[nxt])
            nxt += 1
        active = [r for r in active if r[1] >= mid]
        name = (min(active, key=lambda r: r[1] - r[0])[2] if active
                else "outside the program")
        gaps[name] += (s1 - e0) / 1e6
    return Trace(dict(per), busy, window_s, dict(gaps))


def traced(fn, calls: Calls, top_ranges=("portbench.unit",)):
    """Run fn() under the profiler (CPU and CUDA) with the layer ranges and
    the counting wrappers on. Returns the reduced Trace."""
    from torch.profiler import ProfilerActivity, profile
    names = {n for _m, _a, n in LAYER_SPOTS} | set(top_ranges)
    torch.cuda.synchronize()
    with instrumented(calls):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
    calls.resolve()
    return reduce_events(prof.events(), window, names)


class WindowMeter:
    """The device's busy time over a whole timed window: the profiler on
    CUDA activity alone, stopped and read every `segment_s` seconds of the
    window so that its buffers never fill. A segment's busy time is the
    union of its device intervals (kernels, copies, sets); each segment
    ends at the stop's synchronize, so no interval falls in two."""

    def __init__(self, segment_s: float = 5.0):
        self.segment_s = segment_s
        self.busy_s = 0.0
        self.segments = 0
        self._prof = None
        self._seg_t0 = 0.0

    def warm(self):
        """One short segment at set-up, so the profiler's first start
        (CUPTI's initialization) falls outside the window."""
        self.start(0.0)
        torch.zeros(1, device="cuda").add_(1)
        self._read()
        self.busy_s, self.segments = 0.0, 0

    def start(self, now: float):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._seg_t0 = now

    def tick(self, now: float):
        """After each unit: at a segment's end, read it and start the
        next."""
        if now - self._seg_t0 >= self.segment_s:
            self._read()
            self.start(now)

    def stop(self):
        self._read()

    def _read(self):
        self._prof.stop()           # synchronizes the device first
        cuda = torch.autograd.DeviceType.CUDA
        iv = [(e.start_ns(), e.start_ns() + e.duration_ns())
              for e in self._prof.profiler.kineto_results.events()
              if e.device_type() == cuda]
        self.busy_s += sum(t - s for s, t in merge_intervals(iv)) / 1e9
        self.segments += 1
        self._prof = None
