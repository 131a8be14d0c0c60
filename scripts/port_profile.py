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

Hybrid: chip_smoke's hole scene (the procedural cluster, prims 1 and 4
left out of a 200,000-point cloud) at the recorded hybrid configuration
(runs/quality_cluster_hole_nerf_r5/opt.json), random weights: per train
step (N_PROFILED_STEPS after three warm-up steps on one batch of 3,600
rays) and per request (N_PROFILED_CHUNKS of 3,600 rays after one warm-up),
with K1, K3, K4 and K2 named, for three variants on the same scene and
weights: the points alone (nerf_importance 0), the hybrid, and the hybrid
with the fine pass (fine_sample_num 80, fine_raycolor in the color loss,
as chip_smoke's fine phase runs it). The hybrid's share of a step or
request is the device time it adds to the points alone, the fine pass's
what it adds to the hybrid.

MVS: chip_smoke's DTU-format cluster scene (written under build/mvs;
640 x 512 views, random weights from a seed). Per MVS-init group (3 views,
64 depth planes; N_PROFILED_CHUNKS groups after one warm-up) and per
feed-forward step (train_feedforward_dataset's configuration: nsrc 2, 48
planes, 1,024 rays; N_PROFILED_STEPS after two warm-up steps), with K3 and
K4 (f32) named; MVSNet's share is the device time of MVSNet alone on the
same inputs (the three reference views' forwards for a group; the
train-mode forward and its backward for a step) over the whole group's or
step's.

2D heads (n2d): chip_smoke's phase-23 configuration (bench_config at 128
feature channels on the sphere, 48 x 48 patches, the heads at the fork's
widths): per CNN step and per GAN step (N_PROFILED_STEPS after three
warm-up steps on one patch) with K1, K3 and K4 named, the heads' share
(the head's forward and backward alone on the step's feature image; for
the GAN, the generator side's and the discriminator's four passes: fake,
real, the penalty's double backward, the G side), and per feature request
(N_PROFILED_CHUNKS after one warm-up) with K1, K3 and K2 named.

General (the general decode kernels): chip_smoke's phase-30 setting
bench_config at H = 512 (bf16) on the sphere, per request
(N_PROFILED_CHUNKS of 3,600 rays after one warm-up) and per train step
(N_PROFILED_STEPS after three warm-up steps on one batch), with K1, K3
and K4 named; the kernel table shows each general kernel apart (K3's
k3_tc and its list pass; K4's list pass, k4_rows_tc, k4_dw_tc, k4_slices,
k4_reduce).

    python3 scripts/port_profile.py [--sections main dataset hybrid mvs n2d
                                     general]

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
SECTIONS = ("main", "dataset", "hybrid", "mvs", "n2d", "general")  # main:
# serve, train, probe
# kernel names (substrings) of each port kernel, every route: K1 is
# knn_select_runs_kernel (K <= 16) or knn_select_warp_kernel, K3
# fused_decode_tc_fwd (bf16) or its live-list pass (live_*<false>) and
# fused_decode_f32 (f32) or the general k3_tc / k3_cc, K4 the three
# fused_decode_bwd_tc_* launches (bf16) or its live-list pass
# (live_*<true>) and fused_decode_bwd_f32_* (f32) or the general k4_*
PORT_KERNELS = {"K1": ("knn_select_runs_kernel", "knn_select_warp_kernel"),
                "K3": ("fused_decode_tc_fwd", "fused_decode_f32",
                       "live_flags<false>", "live_compact<false>", "k3_tc",
                       "k3_cc"),
                "K4": ("fused_decode_bwd", "live_flags<true>",
                       "live_compact<true>", "k4_"),
                "K2": ("fused_march_kernel", "fused_march_wide_kernel")}


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


def hybrid_section(cs) -> None:
    """Per train step and per request of the points alone, the hybrid and
    the hybrid with the fine pass, on the hole scene."""
    import dataclasses
    import torch
    from pointnerf_tpu_torch.data.procedural import view_item
    from pointnerf_tpu_torch.models.renderer import ray_batch_from_numpy
    from pointnerf_tpu_torch.train.step import (create_train_state,
                                                eval_step, train_step)
    dev = torch.device("cuda")
    cfg_h = cs.opt_config(cs.HYBRID_OPT)
    variants = {
        "points alone": cfg_h.replace(
            render=dataclasses.replace(cfg_h.render, nerf_importance=0),
            loss=dataclasses.replace(cfg_h.loss, **dict(zip(
                ("color_loss_items", "color_loss_weights"), zip(*[
                    (n, w) for n, w in zip(cfg_h.loss.color_loss_items,
                                           cfg_h.loss.color_loss_weights)
                    if n != "nerf_coarse_raycolor"]))))),
        "hybrid": cfg_h,
        "hybrid + fine pass": cs.fine_config(cfg_h)}
    prims, pc, st, params, grid, views = cs.hole_scene(cfg_h, dev)
    items = [view_item(prims, *v, cs.DS_WH, n_rays=cs.N_RAYS, seed=i,
                       view_id=i) for i, v in enumerate(views)]
    step_ms, req_ms = {}, {}
    for name, cfg in variants.items():
        p = dict(params) if cfg.render.nerf_importance else {
            k: v for k, v in params.items() if k != "nerf"}
        state = create_train_state(torch.Generator(device=dev).manual_seed(2),
                                   p, pc, cfg)
        batch = ray_batch_from_numpy(items[0], cfg, device=dev)
        for _ in range(3):
            state, _it = train_step(state, st, grid, batch, cfg)
        steps = [state]

        def train():
            for _ in range(N_PROFILED_STEPS):
                steps[0], _it = train_step(steps[0], st, grid, batch, cfg)
        n = N_PROFILED_STEPS
        wall, per_kernel, busy = profiled(train)
        total = report(f"{name}, training", n, cs.N_RAYS, wall, per_kernel,
                       busy)
        parts = {k: kernel_ms(per_kernel, PORT_KERNELS[k])
                 for k in ("K1", "K3", "K4")}
        rest = total - sum(parts.values())
        print(f"{name}, per train step, device ms: " + ", ".join(
            f"{k} {ms / n:.4f} ({100 * ms / total:.1f}%)"
            for k, ms in parts.items())
            + f", everything else {rest / n:.4f} ({100 * rest / total:.1f}%); "
            f"kernel total {total / n:.4f}")
        step_ms[name] = (total / n, wall * 1e3 / n)
        reqs = [ray_batch_from_numpy(it, cfg, device=dev)
                for it in items[1:2 + N_PROFILED_CHUNKS]]
        sp = {"mlp": steps[0].params["mlp"], "points": steps[0].params[
            "points"]}
        eval_step(sp, st, grid, reqs[0], cfg)

        def serve():
            for b in reqs[1:]:
                eval_step(sp, st, grid, b, cfg)
        n = N_PROFILED_CHUNKS
        wall, per_kernel, busy = profiled(serve)
        total = report(f"{name}, serving", n, cs.N_RAYS, wall, per_kernel,
                       busy)
        parts = {k: kernel_ms(per_kernel, PORT_KERNELS[k])
                 for k in ("K1", "K3", "K2")}
        rest = total - sum(parts.values())
        print(f"{name}, per request, device ms: " + ", ".join(
            f"{k} {ms / n:.4f} ({100 * ms / total:.1f}%)"
            for k, ms in parts.items())
            + f", everything else {rest / n:.4f} ({100 * rest / total:.1f}%); "
            f"kernel total {total / n:.4f}")
        req_ms[name] = (total / n, wall * 1e3 / n)
        del state, steps
    for what, d in (("train step", step_ms), ("request", req_ms)):
        (p0, h0), (p1, h1), (p2, h2) = (d[k] for k in variants)
        print(f"per {what}, device kernel ms / host ms: points alone "
              f"{p0:.4f} / {h0:.3f}, hybrid {p1:.4f} / {h1:.3f}, + fine "
              f"{p2:.4f} / {h2:.3f}; the hybrid's share of the hybrid "
              f"{what} {100 * (p1 - p0) / p1:.1f}% of device time "
              f"({100 * (h1 - h0) / h1:.1f}% of host time), the fine pass's "
              f"share of the hybrid + fine {what} "
              f"{100 * (p2 - p1) / p2:.1f}% ({100 * (h2 - h1) / h2:.1f}%)")


def mvs_section(cs) -> None:
    """Per MVS-init group and per feed-forward step on the DTU-format
    cluster scene, and MVSNet's share of each."""
    import numpy as np
    import torch
    from pointnerf_tpu_torch.config import DataConfig, scene_config
    from pointnerf_tpu_torch.data.dtu import DtuDataset
    from pointnerf_tpu_torch.data.dtu_ft import DtuFtDataset
    from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
    from pointnerf_tpu_torch.mvs.mvsnet import mvs_precision
    from pointnerf_tpu_torch.mvs.points_init import (gen_scene_points,
                                                     images_nchw,
                                                     init_mvs_points,
                                                     mvs_apply, new_mvs_model,
                                                     view_proj_mats)
    from pointnerf_tpu_torch.train import feedforward as tff
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build", "mvs")
    ft_root, ff_root = cs.write_dtu_scenes(root)
    dev = torch.device("cuda")
    model = new_mvs_model(32, n_views=3, device=dev)
    variables = init_mvs_points(model, torch.Generator().manual_seed(0))

    # MVS init groups (mvs_init_cloud's gen_scene_points call)
    ds = DtuFtDataset(DataConfig(dataset_name="dtu_ft", data_root=ft_root,
                                 scan=cs.DTU_SCAN), split="train")
    groups = [ds.get_mvs_item(i) for i in range(N_PROFILED_CHUNKS + 1)]

    def init_group(g):
        dv = g["depth_values"]
        gen_scene_points(variables["params"], model, g["images"], g["Ks"],
                         g["w2cs"], (float(dv[0]), float(dv[-1])),
                         n_depths=64, batch_stats=variables["batch_stats"],
                         **cs.MVS_INIT_KW)
    init_group(groups[0])
    n = N_PROFILED_CHUNKS
    wall, per_kernel, busy = profiled(lambda: [init_group(g)
                                               for g in groups[1:]])
    total = report("MVS init, group", n, 0, wall, per_kernel, busy)
    ins = []
    for g in groups[1:]:
        dv = torch.linspace(float(g["depth_values"][0]),
                            float(g["depth_values"][-1]), 64, device=dev)
        for ref in range(3):
            order = [ref] + [v for v in range(3) if v != ref]
            ins.append((images_nchw(g["images"][order], dev), torch.tensor(
                view_proj_mats(g["Ks"], g["w2cs"], ref)[order], device=dev),
                dv))

    def mvsnet_only():
        with torch.no_grad():
            for a in ins:
                mvs_apply(model, variables, *a)
    _w, pk_m, _b = profiled(mvsnet_only)
    mvs_ms = sum(v[1] for v in pk_m.values())
    print(f"MVS init, per group, device ms: {total / n:.4f}; MVSNet alone "
          f"(3 reference views) {mvs_ms / n:.4f} = {100 * mvs_ms / total:.1f}"
          f"% of it; host {wall * 1e3 / n:.3f} ms")

    # feed-forward steps (train_feedforward_dataset's configuration)
    dds = DtuDataset(DataConfig(dataset_name="dtu", data_root=ff_root,
                                scan=cs.DTU_SCAN), split="train", nsrc=2,
                     n_depths=cs.FF_DEPTHS)
    g0 = dds.get_mvs_item(0)
    near, far = float(g0["depth_values"][0]), float(g0["depth_values"][-1])
    span = far - near
    cfg = scene_config(np.array([[-span] * 3, [span] * 3], np.float32),
                       near=near, far=far)
    W, H = cs.MVS_WH
    cap = (H // 4) * (W // 4)
    agg = init_aggregator_params(cfg.agg, torch.Generator().manual_seed(1),
                                 device=dev)
    state = tff.create_ff_state(torch.Generator(device=dev).manual_seed(2),
                                variables, agg, cfg)
    step, _infer = tff.make_feedforward_step(cfg, model, cap)
    item = dds.get_item(0, random_sample="random",
                        random_sample_size=int(np.sqrt(cs.FF_RAYS)), seed=0)
    batch = cs.ff_batch(g0, item, cfg, dev)
    states = [state]

    def train(k):
        for _ in range(k):
            states[0], _it = step(states[0], batch)
    train(2)
    n = N_PROFILED_STEPS
    wall, per_kernel, busy = profiled(lambda: train(n))
    total = report("feed-forward, training", n, cs.FF_RAYS, wall, per_kernel,
                   busy)
    parts = {k: kernel_ms(per_kernel, PORT_KERNELS[k]) for k in ("K3", "K4")}
    params = {k: v.detach().requires_grad_()
              for k, v in states[0].params["mvs"].items()}

    def mvsnet_fwd_bwd():
        for _ in range(n):
            stats = {k: v.clone() for k, v in states[0].mvs_stats.items()}
            with torch.enable_grad(), mvs_precision():
                d, _c, f, _p = mvs_apply(model, {"params": params,
                                                 "batch_stats": stats},
                                         batch.images, batch.proj_mats,
                                         batch.depth_values, True)
                torch.autograd.grad(d.sum() + f.sum(), list(params.values()),
                                    allow_unused=True)
    mvsnet_fwd_bwd()
    _w, pk_m, _b = profiled(mvsnet_fwd_bwd)
    mvs_ms = sum(v[1] for v in pk_m.values())
    print(f"feed-forward, per step, device ms: " + ", ".join(
        f"{k} {ms / n:.4f} ({100 * ms / total:.1f}%)"
        for k, ms in parts.items())
        + f"; MVSNet forward + backward alone {mvs_ms / n:.4f} = "
        f"{100 * mvs_ms / total:.1f}% of the step's {total / n:.4f}; host "
        f"{wall * 1e3 / n:.3f} ms a step; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")


def n2d_section(cs) -> None:
    """Per CNN step, per GAN step and per feature request at chip_smoke's
    phase-23 configuration, and the heads' share of each step."""
    import torch
    from pointnerf_tpu_torch.models.neural_render import apply_head
    from pointnerf_tpu_torch.mvs.mvsnet import mvs_precision
    from pointnerf_tpu_torch.train.step import eval_step
    dev = torch.device("cuda")
    cfg = cs.n2d_config()
    pc, st, params, grid = cs.make_scene(cfg, dev)
    heads, hp = cs.n2d_heads(dev)
    batch, gt = cs.n2d_patch(cfg, 0, dev)
    steps = cs.n2d_steps(cfg, heads)
    P, C = cs.N2D_PATCH, cs.N2D_C
    n = N_PROFILED_STEPS
    for kind in ("cnn", "gan"):
        states = [cs.n2d_states(kind, hp, params, pc, dev)]

        def train(k, kind=kind, states=states):
            for _ in range(k):
                states[0], _it = steps[kind](states[0], st, grid, batch, gt,
                                             0 if kind == "cnn" else 1)
        train(3)
        wall, per_kernel, busy = profiled(lambda: train(n))
        total = report(f"n2d {kind} step", n, P * P, wall, per_kernel, busy)
        parts = {k: kernel_ms(per_kernel, PORT_KERNELS[k])
                 for k in ("K1", "K3", "K4")}
        prm = {g: {k: v.detach().requires_grad_() for k, v in
                   states[0].params[g].items()} for g in ("head",)}
        img = torch.rand((1, C, P, P), device=dev, requires_grad=True)
        real = gt.permute(2, 0, 1)[None]
        if kind == "gan":
            dp = {k: v.detach().requires_grad_()
                  for k, v in states[0].d_params.items()}
            w = torch.rand((1, 1, cs.N2D_Z), device=dev)

        def heads_only(kind=kind):
            for _ in range(n):
                with torch.enable_grad(), mvs_precision():
                    if kind == "cnn":
                        rgb = apply_head(heads["cnn"], prm["head"], img)
                        torch.autograd.grad(rgb.sum(), [img] + list(
                            prm["head"].values()))
                        continue
                    rgb = apply_head(heads["gen"], prm["head"], w, img)
                    fake = rgb.detach()
                    x = real.detach().requires_grad_()
                    r = apply_head(heads["disc"], dp, x).sum()
                    g, = torch.autograd.grad(r, x, create_graph=True)
                    d = (apply_head(heads["disc"], dp, fake).sum() + r
                         + (g ** 2).sum())
                    torch.autograd.grad(d, list(dp.values()))
                    adv = apply_head(heads["disc"], dp, rgb).sum()
                    torch.autograd.grad(rgb.sum() + adv, [img] + list(
                        prm["head"].values()))
        heads_only()
        _w, pk_h, _b = profiled(heads_only)
        head_ms = sum(v[1] for v in pk_h.values())
        rest = total - sum(parts.values()) - head_ms
        print(f"n2d {kind} step, per step, device ms: " + ", ".join(
            f"{k} {ms / n:.4f} ({100 * ms / total:.1f}%)"
            for k, ms in parts.items())
            + f", the heads alone {head_ms / n:.4f} "
            f"({100 * head_ms / total:.1f}%), everything else {rest / n:.4f}"
            f" ({100 * rest / total:.1f}%); kernel total {total / n:.4f}, "
            f"host {wall * 1e3 / n:.3f} ms")
    p = {"mlp": params, "points": pc}
    reqs = [cs.n2d_patch(cfg, v % cs.N2D_REQUESTS, dev)[0]
            for v in range(N_PROFILED_CHUNKS + 1)]
    eval_step(p, st, grid, reqs[0], cfg)

    def serve():
        for b in reqs[1:]:
            eval_step(p, st, grid, b, cfg)
    m = N_PROFILED_CHUNKS
    wall, per_kernel, busy = profiled(serve)
    total = report("n2d feature request", m, P * P, wall, per_kernel, busy)
    parts = {k: kernel_ms(per_kernel, PORT_KERNELS[k])
             for k in ("K1", "K3", "K2")}
    rest = total - sum(parts.values())
    print("n2d feature request, per request, device ms: " + ", ".join(
        f"{k} {ms / m:.4f} ({100 * ms / total:.1f}%)"
        for k, ms in parts.items())
        + f", everything else {rest / m:.4f} ({100 * rest / total:.1f}%)")


def general_section(cs) -> None:
    """Per request and per train step at phase 30's H = 512 setting."""
    import torch
    from pointnerf_tpu_torch.train.step import (create_train_state,
                                                eval_step, train_step)
    base = cs.slice_config()
    cfg = cs.agg_config(base, *cs.AGG_GENERAL["h512"])
    pc, st, _params, grid = cs.make_scene(base, torch.device("cuda"))
    params = cs.agg_params(cfg)
    p = {"mlp": params, "points": pc}
    reqs = cs.batches(cfg, cs.N_RAYS, N_PROFILED_CHUNKS + 1, "cuda")
    eval_step(p, st, grid, reqs[0], cfg)

    def serve():
        for b in reqs[1:]:
            eval_step(p, st, grid, b, cfg)
    wall, per, busy = profiled(serve)
    total = report("general h512 request", N_PROFILED_CHUNKS, cs.N_RAYS,
                   wall, per, busy)
    for k in ("K1", "K3", "K2"):
        ms = kernel_ms(per, PORT_KERNELS[k]) / N_PROFILED_CHUNKS
        print(f"  {k}: {ms:.4f} ms each "
              f"({100 * ms * N_PROFILED_CHUNKS / total:.1f}%)")
    state = create_train_state(torch.Generator(device="cuda").manual_seed(2),
                               params, pc, cfg)
    tbatch = cs.batches(cfg, cs.N_RAYS, 1, "cuda")[0]
    for _ in range(3):
        state, _items = train_step(state, st, grid, tbatch, cfg)
    box = [state]

    def train():
        for _ in range(N_PROFILED_STEPS):
            box[0], _it = train_step(box[0], st, grid, tbatch, cfg)
    wall, per, busy = profiled(train)
    total = report("general h512 train step", N_PROFILED_STEPS, cs.N_RAYS,
                   wall, per, busy)
    for k in ("K1", "K3", "K4"):
        ms = kernel_ms(per, PORT_KERNELS[k]) / N_PROFILED_STEPS
        print(f"  {k}: {ms:.4f} ms each "
              f"({100 * ms * N_PROFILED_STEPS / total:.1f}%)")


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
    if "hybrid" in sections:
        hybrid_section(cs)
    if "mvs" in sections:
        mvs_section(cs)
    if "n2d" in sections:
        n2d_section(cs)
    if "general" in sections:
        general_section(cs)
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
