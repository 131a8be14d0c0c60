#!/usr/bin/env python3
"""Where the time of one eval request and of one training step of the
PyTorch port goes, on the card.

    python3 scripts/port_profile.py

Builds the scene of chip_smoke.py (65,536-point sphere, bench_config with
knn_select="pallas", fused_decode=True, fused_march=True).

Serving: two warm-up requests, then chip_smoke's main path (N_REQUESTS
requests of N_RAYS rays) under torch.profiler (CPU + CUDA activities).
Prints the host-clock time per request, each device kernel's summed time and
share, the three port kernels' share, and the device's busy and idle shares
(union of kernel intervals over the synchronized host window).

Training: bench.py's warm-up (N_TRAIN_WARMUP steps of one N_RAYS batch),
then N_PROFILED_STEPS train_step calls under the profiler. Prints the same
breakdown per step, with K1, K3 and K4 named. The plain march (training does
not run K2, as in JAX) is a few dozen small PyTorch kernels in its forward
and in autograd's backward, so its device time is read apart: the march is
replayed on the inputs a step gave it, forward and backward, under the
profiler, and "everything else" is the step's kernel time less K1, K3, K4
and that replay.

Probe: one full-frame probe (prob=True, the dense decode) of the probe view
of chip_smoke's maintenance scene (the sphere with view 0's silhouette band
cut), chunks of 2,304 rays as train/grow.py renders them, after one warm-up
frame. Prints the breakdown per chunk, with K1, K3 and K2 named.

Dataset: the nerf_synth scene of chip_smoke's dataset path (written under
build/nerf_synth) at its scene_config (dense f32 decode, bucket +
shell-layered KNN): N_PROFILED_STEPS train steps of 3,600 rays after two
warm-up steps, and N_PROFILED_CHUNKS eval chunks of 9,216 rays of the test
view after one warm-up chunk, each broken down with K3 and K4 (f32, CUDA
cores) and K2 named.

    python3 scripts/port_profile.py [--sections main dataset]

Needs one CUDA card.
"""
from __future__ import annotations

import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_PROFILED_STEPS = 4
N_PROFILED_CHUNKS = 4
SECTIONS = ("main", "dataset")   # main: serving, training and the probe
# kernel names (substrings) of each port kernel, every route: K1 is
# knn_select_runs_kernel (K <= 16) or knn_select_warp_kernel, K3
# fused_decode_tc_fwd (bf16) or its live-list pass (live_*<false>) and
# fused_decode_f32 (f32), K4 the three fused_decode_bwd_tc_* launches (bf16)
# or its live-list pass (live_*<true>) and fused_decode_bwd_f32_* (f32)
PORT_KERNELS = {"K1": ("knn_select_runs_kernel", "knn_select_warp_kernel"),
                "K3": ("fused_decode_tc_fwd", "fused_decode_f32",
                       "live_flags<false>", "live_compact<false>"),
                "K4": ("fused_decode_bwd", "live_flags<true>",
                       "live_compact<true>"),
                "K2": ("fused_march_kernel",)}


def profiled(fn):
    """Run fn under torch.profiler. Returns (host seconds, {kernel name:
    [calls, device ms]}, device busy ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    return wall, per_kernel, busy


def kernel_ms(per_kernel, keys) -> float:
    return sum(v[1] for k, v in per_kernel.items()
               if any(key in k for key in keys))


def report(what: str, n: int, n_rays: int, wall: float, per_kernel,
           busy: float) -> float:
    """Print the breakdown per unit (request or step); returns the total
    device kernel ms."""
    wall_ms = wall * 1e3
    print(f"{what}: {n} x {n_rays} rays: host {wall_ms / n:.3f} ms each "
          f"({n * n_rays / wall:.1f} rays/s), "
          f"device busy {busy / n:.3f} ms each = {100 * busy / wall_ms:.1f}% "
          f"of the window, idle {100 * (1 - busy / wall_ms):.1f}%")
    total = sum(v[1] for v in per_kernel.values())
    print(f"{'kernel':70s} {'calls':>6s} {'ms each':>9s} {'share':>7s}")
    for name, (cnt, ms) in sorted(per_kernel.items(),
                                  key=lambda kv: -kv[1][1])[:20]:
        print(f"{name[:70]:70s} {cnt / n:6.1f} {ms / n:9.4f} "
              f"{100 * ms / total:6.1f}%")
    return total


def dataset_section(cs) -> None:
    """Per train step and per eval chunk of the dataset path."""
    import numpy as np
    import torch
    from pointnerf_tpu_torch.config import DataConfig
    from pointnerf_tpu_torch.data import find_dataset_class_by_name
    from pointnerf_tpu_torch.models.points import make_point_cloud
    from pointnerf_tpu_torch.models.renderer import (RayBatch,
                                                     ray_batch_from_numpy)
    from pointnerf_tpu_torch.train.driver import init_mlp_params
    from pointnerf_tpu_torch.train.step import (create_train_state,
                                                eval_step, refresh_grid,
                                                train_step)
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "build", "nerf_synth")
    cs.write_nerf_synth_scene(os.path.join(root, cs.DS_SCAN))
    cls = find_dataset_class_by_name("nerf_synth360_ft")
    dcfg = DataConfig(data_root=root, scan=cs.DS_SCAN)
    train_ds, test_ds = cls(dcfg, split="train"), cls(dcfg, split="test")
    cloud = train_ds.load_init_points()
    cfg = cs.dataset_config(cloud["xyz"])
    dev = torch.device("cuda")
    pc, st = make_point_cloud(cloud["xyz"], torch.Generator().manual_seed(0),
                              cfg.points, cfg.agg.point_features_dim,
                              color=cloud.get("color"), device=dev)
    params = init_mlp_params(torch.Generator().manual_seed(1), cfg,
                             device=dev)
    grid, _ = refresh_grid(pc, st, cfg)
    state = create_train_state(torch.Generator(device=dev).manual_seed(2),
                               params, pc, cfg)
    batches = [ray_batch_from_numpy(train_ds.get_item(
        i % len(train_ds), random_sample="random", random_sample_size=60,
        seed=i), cfg, device=dev) for i in range(2 + N_PROFILED_STEPS)]
    for b in batches[:2]:
        state, _it = train_step(state, st, grid, b, cfg)
    steps = [state]

    def train():
        for b in batches[2:]:
            steps[0], _it = train_step(steps[0], st, grid, b, cfg)
    n = N_PROFILED_STEPS
    wall, per_kernel, busy = profiled(train)
    total = report("dataset training", n, cs.N_RAYS, wall, per_kernel, busy)
    parts = {k: kernel_ms(per_kernel, PORT_KERNELS[k]) for k in ("K3", "K4")}
    rest = total - sum(parts.values())
    print("per dataset train step, device ms: " + ", ".join(
        f"{k} f32 {ms / n:.4f} ({100 * ms / total:.1f}%)"
        for k, ms in parts.items())
        + f", everything else {rest / n:.4f} ({100 * rest / total:.1f}%); "
        f"kernel total {total / n:.4f}")

    item = test_ds.get_item(0)
    chunk = 9216
    mid = len(item["raydir"]) // 2 - chunk * (N_PROFILED_CHUNKS + 1) // 2
    p = {"mlp": steps[0].params["mlp"], "points": steps[0].params["points"]}

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)
    chunks = [RayBatch(campos=t(item["campos"]),
                       camrotc2w=t(item["camrotc2w"]),
                       raydir=t(item["raydir"][s:s + chunk]),
                       pixel_idx=torch.zeros((chunk, 2), dtype=torch.int32,
                                             device=dev),
                       near=t(cfg.render.near_plane),
                       far=t(cfg.render.far_plane))
              for s in range(mid, mid + chunk * (N_PROFILED_CHUNKS + 1),
                             chunk)]
    eval_step(p, st, grid, chunks[0], cfg)

    def evaluate():
        for b in chunks[1:]:
            eval_step(p, st, grid, b, cfg)
    n = N_PROFILED_CHUNKS
    wall, per_kernel, busy = profiled(evaluate)
    total = report("dataset eval, per chunk", n, chunk, wall, per_kernel,
                   busy)
    parts = {k: kernel_ms(per_kernel, PORT_KERNELS[k]) for k in ("K3", "K2")}
    rest = total - sum(parts.values())
    print("per dataset eval chunk (the middle of the test view), device ms: "
          + ", ".join(f"{k} {ms / n:.4f} ({100 * ms / total:.1f}%)"
                      for k, ms in parts.items())
          + f", everything else {rest / n:.4f} ({100 * rest / total:.1f}%)")


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sections", nargs="+", choices=SECTIONS,
                    default=list(SECTIONS))
    sections = ap.parse_args().sections
    import torch
    if not torch.cuda.is_available():
        sys.exit("port_profile: needs a CUDA card")
    import chip_smoke as cs
    from pointnerf_tpu_torch.models import renderer
    from pointnerf_tpu_torch.train.step import (create_train_state,
                                                eval_step, train_step)

    print(f"card: {cs.card_line()}")
    if "dataset" in sections:
        dataset_section(cs)
    if "main" not in sections:
        return
    cfg = cs.slice_config()
    pc, st, params, grid = cs.make_scene(cfg, torch.device("cuda"))

    # serving
    reqs = cs.batches(cfg, cs.N_RAYS, cs.N_REQUESTS + 2, "cuda")
    p = {"mlp": params, "points": pc}
    for b in reqs[:2]:
        eval_step(p, st, grid, b, cfg)

    def serve():
        for b in reqs[2:]:
            eval_step(p, st, grid, b, cfg)
    n = cs.N_REQUESTS
    wall, per_kernel, busy = profiled(serve)
    total = report("serving", n, cs.N_RAYS, wall, per_kernel, busy)
    parts = {k: kernel_ms(per_kernel, PORT_KERNELS[k])
             for k in ("K1", "K2", "K3")}
    ours = sum(parts.values())
    print("per request, device ms: " + ", ".join(
        f"{k} {ms / n:.4f}" for k, ms in parts.items()))
    print(f"port kernels (K1+K2+K3): {ours / n:.4f} ms/request = "
          f"{100 * ours / total:.1f}% of device kernel time; everything "
          f"else: {(total - ours) / n:.4f} ms/request")

    # training
    state = create_train_state(torch.Generator(device="cuda").manual_seed(2),
                               params, pc, cfg)
    batch = cs.batches(cfg, cs.N_RAYS, 1, "cuda")[0]
    for _ in range(cs.N_TRAIN_WARMUP):
        state, _items = train_step(state, st, grid, batch, cfg)
    march_args = []
    real_march = renderer.ray_march

    def rec(*a, **k):
        march_args.append((a, k))
        return real_march(*a, **k)
    renderer.ray_march = rec
    try:
        state, _items = train_step(state, st, grid, batch, cfg)
    finally:
        renderer.ray_march = real_march
    steps = [state]

    def train():
        for _ in range(N_PROFILED_STEPS):
            steps[0], _it = train_step(steps[0], st, grid, batch, cfg)
    n = N_PROFILED_STEPS
    wall, per_kernel, busy = profiled(train)
    total = report("training", n, cs.N_RAYS, wall, per_kernel, busy)

    (a, k), = march_args
    dist, valid, feats = a[0], a[1], a[2]

    def march():
        for _ in range(n):
            f = feats.detach().requires_grad_()
            outs = real_march(dist, valid, f, *a[3:], **k)
            used = [o for o in outs if o is not None and o.requires_grad]
            torch.autograd.grad([o.sum() for o in used], f)
    _w, march_kernels, _b = profiled(march)
    march_ms = sum(v[1] for v in march_kernels.values())
    parts = {name: kernel_ms(per_kernel, PORT_KERNELS[name])
             for name in ("K1", "K3", "K4")}
    rest = total - sum(parts.values()) - march_ms
    print("per training step, device ms: " + ", ".join(
        f"{name} {ms / n:.4f} ({100 * ms / total:.1f}%)"
        for name, ms in parts.items())
        + f", plain march fwd+bwd (replayed) {march_ms / n:.4f} "
        f"({100 * march_ms / total:.1f}%), everything else {rest / n:.4f} "
        f"({100 * rest / total:.1f}%); kernel total {total / n:.4f}")

    # a probe frame
    from pointnerf_tpu_torch.models.points import make_point_cloud
    from pointnerf_tpu_torch.train.grow import render_full_frame
    from pointnerf_tpu_torch.train.step import refresh_grid
    (xyz, color, normals), conf, _ti, (item,), _test = cs.maintenance_scene()
    mpc, mst = make_point_cloud(xyz, torch.Generator().manual_seed(0),
                                cfg.points, cfg.agg.point_features_dim,
                                color=color, dirs=normals, conf=conf,
                                device="cuda")
    mgrid, _ = refresh_grid(mpc, mst, cfg)
    mp = {"mlp": params, "points": mpc}
    render_full_frame(mp, mst, mgrid, cfg, item, cs.MAINT_WH)
    wall, per_kernel, busy = profiled(
        lambda: render_full_frame(mp, mst, mgrid, cfg, item, cs.MAINT_WH))
    n = -(-len(item["raydir"]) // 2304)
    total = report("probe frame, per chunk", n, 2304, wall, per_kernel, busy)
    parts = {k: kernel_ms(per_kernel, PORT_KERNELS[k])
             for k in ("K1", "K3", "K2")}
    rest = total - sum(parts.values())
    print(f"probe frame: {n} chunks, host {wall:.4f} s; per chunk, device "
          f"ms: " + ", ".join(f"{k} {ms / n:.4f} ({100 * ms / total:.1f}%)"
                              for k, ms in parts.items())
          + f", everything else {rest / n:.4f} ({100 * rest / total:.1f}%)")


if __name__ == "__main__":
    main()
