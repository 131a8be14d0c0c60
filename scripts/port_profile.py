#!/usr/bin/env python3
"""Where the time of one eval request of the PyTorch port goes, on the card.

    python3 scripts/port_profile.py

Builds the scene of chip_smoke.py (65,536-point sphere, bench_config with
knn_select="pallas", fused_decode=True, fused_march=True), serves two
warm-up requests, then serves chip_smoke's main path (N_REQUESTS requests
of N_RAYS rays) under torch.profiler
(CPU + CUDA activities). Prints the host-clock time per request, each device
kernel's summed time and share of the window, the three port kernels'
share, and the device's busy and idle shares (union of kernel intervals
over the synchronized host window). Needs one CUDA card.
"""
from __future__ import annotations

import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("port_profile: needs a CUDA card")
    import chip_smoke as cs
    from pointnerf_tpu_torch.train.step import eval_step
    from torch.profiler import ProfilerActivity, profile

    print(f"card: {cs.card_line()}")
    cfg = cs.slice_config()
    pc, st, params, grid = cs.make_scene(cfg, torch.device("cuda"))
    reqs = cs.batches(cfg, cs.N_RAYS, cs.N_REQUESTS + 2, "cuda")
    p = {"mlp": params, "points": pc}
    for b in reqs[:2]:
        eval_step(p, st, grid, b, cfg)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in reqs[2:]:
            eval_step(p, st, grid, b, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    intervals, per_kernel = [], defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            intervals.append((e.time_range.start, e.time_range.end))
            k = per_kernel[e.name]
            k[0] += 1
            k[1] += (e.time_range.end - e.time_range.start) / 1e3   # ms
    if not intervals:
        sys.exit("port_profile: the profiler recorded no device activity")
    intervals.sort()
    busy, cur_s, cur_e = 0.0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + cur_e - cur_s) / 1e3                              # ms
    wall_ms = wall * 1e3
    n = cs.N_REQUESTS
    print(f"{n} requests x {cs.N_RAYS} rays: host {wall_ms / n:.3f} ms/request "
          f"({n * cs.N_RAYS / wall:.1f} rays/s), device busy {busy / n:.3f} "
          f"ms/request = {100 * busy / wall_ms:.1f}% of the window, idle "
          f"{100 * (1 - busy / wall_ms):.1f}%")
    total = sum(v[1] for v in per_kernel.values())
    print(f"{'kernel':70s} {'calls':>6s} {'ms/req':>9s} {'share':>7s}")
    for name, (cnt, ms) in sorted(per_kernel.items(),
                                  key=lambda kv: -kv[1][1])[:20]:
        print(f"{name[:70]:70s} {cnt // n:6d} {ms / n:9.4f} "
              f"{100 * ms / total:6.1f}%")
    ours = {k: v for k, v in per_kernel.items()
            if any(s in k for s in ("knn_select_kernel", "fused_decode_kernel",
                                    "fused_march_kernel"))}
    ms_ours = sum(v[1] for v in ours.values())
    print(f"port kernels (K1+K2+K3): {ms_ours / n:.4f} ms/request = "
          f"{100 * ms_ours / total:.1f}% of device kernel time; everything "
          f"else: {(total - ms_ours) / n:.4f} ms/request")


if __name__ == "__main__":
    main()
