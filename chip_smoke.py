#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases:
  1. the card's name and power limit (nvidia-smi);
  2. build the six kernel sources of pointnerf_tpu_torch/csrc (one nvcc
     per source, in parallel) and print the build time and ptxas summary:
     K1, K2, and K3 and K4 on two routes each — bf16 on the tensor-core
     kernels (fused_decode_tc.cu, fused_decode_bwd_tc.cu), f32 on the
     CUDA-core ones (fused_decode.cu, fused_decode_bwd.cu);
  3. the scene of both main paths — a 65,536-point sphere_scene (seed 0),
     its grid with the prebuilt neighbor tables, random aggregator weights
     from a seed — at bench_config with knn_select="pallas",
     fused_decode=True and fused_march=True. The requests are rendered once
     to record each kernel's real inputs; then each kernel is held against
     its plain PyTorch version on the card on those inputs (K1 at C = 36,352
     slots x QP = 243 candidates, bit-equal, with its run statistics, and K2
     at R = 3600 x SR = 80 within K2_TOL, on the first request; K3 at
     M = 290,816 rows in bf16 and in f32 on every request), with its time,
     the plain version's time and the bound — K1 and K2, a few µs each, on
     the device's clock (graph_ms: a CUDA graph of 50 launches, so the
     wrapper's host time is not in the reading) with the wrapper's host µs
     per call beside it, the longer kernels by back-to-back calls between
     two events (cuda_ms); beside K3 and
     K4, as a printed yardstick only, the same layer products as a chain of
     bf16 torch.matmul calls (gemm_chain_ms), which the port never calls;
  4. the serving path: the launch counts are set to 0, eval_step serves 4
     requests of 3,600 rays (4 views), every kernel's count must grow with
     every request, every decode launch must take the tensor-core route and
     every K1 launch its run path (K = 8), colors must be finite;
  5. one 512-ray request on the card and the same on the CPU through the
     plain versions: integers equal, colors of the rays that hit within the
     bf16 bar;
  6. one training step records K4's real inputs (M = 290,816 rows and the
     upstream gradients); K4 is held against its plain version on them, in
     bf16 and in f32, on the row gradients and every dW/db, with its time,
     the plain version's time and the bound (the bytes of the tensor-core
     K4's second phase, a cost of its design, are printed apart); two bf16
     calls must give the same bits;
  7. the training path: the launch counts are set to 0, train_step takes 3
     warm-up and 20 timed steps of 3,600 rays on one batch, as bench.py
     does; each step must launch K1, K3 and K4 once each, K1 on its run
     path, K3 and K4 on the tensor-core route (training takes the plain
     march, as the JAX package does, so K2 is not launched); the loss must
     be finite at every step and the mean of the last 5 below the mean of
     the first 5; prints the train rays/s;
  8. the gradients of one 512-ray training step on the card and on the CPU
     (the same jitter draw) from the state the timed steps left: integers
     equal, the loss, the MLP gradients and the point-payload gradients
     within their bf16 bars;
  9. the maintenance path: the launch counts are set to 0 and
     train_scene runs 40 steps of 3,600 rays on the same sphere with the
     points within 25 degrees of view 0's silhouette cut (grazing rays
     miss: a hole) and every 8th point's conf below prune_thresh, with
     prunes at 10/20/30/40, probe-hole growth over view 0 at 15/30 (dense
     prob-mode chunks of 2,304 rays), splits at 20/40, an eval of view 4
     at 35 and checkpoints at 25 and 40; then train_scene resumes from the
     last checkpoint to step 44. Checks: each prune keeps exactly the
     points with conf > prune_thresh; the first probe finds missed rays and
     grows; every grown point lies within the KNN radius of the cloud
     before it (the first grow's also of the sphere); a split adds points;
     the grid is rebuilt after every change of the point set with the
     carried max_d; every train step launches K1, K3 and K4 once, every
     probe or eval chunk K1, K3 and K2 once, on their main routes; losses
     and PSNR are finite; the resumed state equals the saved one bit for
     bit. Prints the seconds per prune, probe frame, grow, split, grid
     rebuild, eval frame, checkpoint save and load, and the loop's train
     rays/s. Then K1 (bit-equal), K2 (within K2_TOL) and K3 (bf16 and
     f32, as in phase 3) are held against their plain versions on one
     recorded dense probe chunk (C = 184,320 slots, M = 1,474,560 rows,
     R = 2,304) and one recorded eval chunk (C = 92,160, M = 737,280,
     R = 9,216), and a 16 x 16 window of the first probe frame around a
     hole's edge is rendered with the probe outputs on the card and on the
     CPU from the state that probe saw: masks and neighbor ids equal, the
     argmax sample equal on every ray outside a fixed near-tie margin (at
     most MAX_TIE_SHARE of the hit rays inside it), the opacities (per
     sample and the peak) on their mean error and the other probe outputs
     on their largest, each beside a control;
 10. the dataset path: a NeRF-Synthetic-format scene of the procedural
     cluster is written under build/nerf_synth (6 train and 1 test views
     of 800 x 800 from the analytic ground truth, blender poses at
     distance 4.0, points.ply of 200,000 surface samples), and the launch
     counts are set to 0; train_dataset_scene runs 16 steps of 3,600 rays
     at scene_config() as it builds it (K=8, SR=80, D=400, H=256, f32,
     dense decode, bucket + shell-layered KNN, both fused flags off) with
     only the schedule cut (a prune at 10, an eval of the test view and a
     checkpoint at 16), then test_dataset_scene from that checkpoint.
     Checks: each step launches K3 and K4 once on the CUDA-core (f32)
     route, each eval chunk (9,216 rays) K3 and K2 once, K1 never; the
     prune keeps the points with conf > prune_thresh; the loaded state
     equals the saved one; the two PSNRs agree within 0.01 dB. K3 f32 and
     K4 f32 are then held against their plain versions (2e-4 of scale) on
     a recorded train step (M = 2,304,000 rows) and K3 f32 on a recorded
     eval chunk (M = 5,898,240), with times, bounds and shares of the
     bound; two K4 f32 calls must give the same bits; the kernels'
     live-group list must equal its plain version, and the rows with
     weight, the live groups x K (the rows the f32 kernels decode) and the
     rows of 64-row tiles with a weighted row (what a test per tile would
     decode) are printed for the step and the chunk, and the f32 times
     beside the first f32 kernels' readings (FIRST_F32_MS);
 11. the query branches: 512 rays of the test view through every ray
     generator (and the jittered ones from one shared draw) and every KNN
     branch (bucket rows or prebuilt tables; K nearest, shell-layered, the
     NN=0 random subset) on the card and on the CPU: slot masks, ray masks
     and neighbor ids equal;
 12. construct_vox_points_closest on a 2,500,000-point cluster cloud on
     the card and on the CPU: ids and centroids equal;
 13. the flags-off path: the JAX package's recorded quality configuration
     (runs/quality_cluster_full_r5/opt.json, loaded as it is: prebuilt
     tables, compacted decode at 0.4, bf16, fused_decode and fused_march
     off) on a 200,000-point cluster cloud, launch counts set to 0: a
     512-ray request on the card against the CPU with the flags set (the
     kernels' plain versions) at random weights, under phase 5's bars;
     3 + 10 train steps of 3,600 rays (K1 on its run path, K3 and K4 on
     the tensor cores, once each a step) and 2 serving requests (K1, K3
     and K2 once each); the parity request again from the trained state,
     integers equal and colors within COLOR_TRAINED_BF16_TOL. Then K3 and
     K4 bf16 are held against their plain versions on the first train
     step's recorded inputs (921,600 rows), and K1, K3 and K2 on the first
     request's, at the bars of phases 3-5;
 14. the kernels JSON line (one row per kernel source; K3 and K4 have a
     tensor-core row and a CUDA-core row, counted by route; launches per
     path: serve, train, maintenance, dataset, flags_off; each kernel's
     numbers on the maintenance path's probe and eval chunks and on the
     flags-off path's train step and request), the card line, and the
     final status line.

Each bf16 bar is also held against a control: the same comparison with the
f32 plain version in place of the bf16 one, which must land above the bar,
so a kernel that skipped a bf16 rounding point would fail. K3 and K4 in
bf16 are held there on the mean error (mean |kernel - plain| / mean
|plain|): any change of summation order moves a few elements by a bf16 step,
so the largest error of a sound kernel is of the control's order. Their
largest error is held apart, tensor by tensor, against that of the plain
version summed in f64 (hold_max), which catches a fault in a few rows.

Any failure exits non-zero before the status line. Without a CUDA device,
or without the pointnerf_tpu_torch package beside it, it exits 1.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

# tolerances of the kernel-vs-plain comparisons on the card
K2_TOL = 1e-5          # march: the PERF.md parity bar
K3_F32_TOL = 2e-4      # decode in f32: the parity bar, relative to max|plain|
# bf16 bars sit between the error of a sound run and the control, as read
# on an H100 80GB HBM3 at 700 W (PERF.md): colors 2.3e-6 vs 9.8e-5
# (absolute). K3 and K4 in bf16 are held on mean |kernel - plain| /
# mean |plain| (worst output or gradient): a bf16 rounding that lands on the
# other side of a tie when a sum runs in another order (the tensor cores'
# order, or f64's) moves one element by a bf16 step, so the largest error of
# any other summation order is that of the control's order of size (PERF.md
# §6); the mean tells them apart. Readings: K3 2.2e-5 vs control 3.9e-3,
# K4 4.1e-4 vs control 8.4e-2.
K3_BF16_TOL = 1e-4     # decode in bf16, mean relative error
COLOR_BF16_TOL = 1e-5  # card vs CPU colors of the rays that hit, bf16 decode
# the same, from the flags-off path's trained state: the colors there also
# carry the bf16 color head's roundings (cuBLAS and the CPU sum in other
# orders), which weigh more as the opacities grow. Readings on an H100 80GB
# HBM3 at 700 W (PERF.md §6): 5.7e-05 to 1.06e-04, control 5.2e-04 to
# 6.1e-04
COLOR_TRAINED_BF16_TOL = 2.5e-4
K4_F32_TOL = 2e-4      # decode backward in f32, per gradient, of max|plain|
K4_BF16_TOL = 5e-3     # decode backward in bf16, mean relative error
# K3 and K4 in bf16 are also held on their largest error, output by output
# and gradient by gradient (hold_max): at most MAX_FACTOR times the largest
# distance of the f64-summed plain version from the f32 one, plus the f32
# route's bar for a sum in another order. A fault confined to a few rows (a
# live tile taken for dead, or left out of dW) shows there, not in the mean.
MAX_FACTOR = 2.0
# card vs CPU probe outputs of the maintenance path's probe window. The
# outputs read at the argmax sample from the neighbor weights and payloads,
# which no decode touches: max |card - CPU| / max |CPU| on the rays
# compared (control: each ray's neighbor's value; read <= 2.3e-07 against
# ~1 on an H100 80GB HBM3 at 700 W, PERF.md §6).
PROBE_TOL = {"ray_max_sample_loc_w": 1e-5, "ray_max_far_dist": 1e-5,
             "shading_avg_color": 1e-5, "shading_avg_dir": 1e-5,
             "shading_avg_conf": 1e-5, "shading_avg_embedding": 1e-5}
# The opacities come out of the bf16 decode: each sample's of the hit rays
# and each compared ray's peak, held on mean |card - CPU| / mean |CPU|
# (control: the CPU with an f32 decode). Like K3's outputs, their largest
# bf16 error wanders toward the control's order as a rounding tie falls on
# either side (per sample 6.7e-05 to 4.2e-04 of max|CPU|, the peak 2.3e-05
# to 2.4e-04), so they are held on the mean, as K3 is. Readings on an H100
# 80GB HBM3 at 700 W (PERF.md §6): per sample 2.5e-06 to 3.2e-06, control
# 5.8e-04; the peak 5.3e-06, control 8.0e-04.
OPACITY_BF16_TOL = 1e-4
# a ray whose two largest CPU opacities lie within this share of max|CPU|
# is a near tie, and its argmax is not compared: twice the largest
# per-sample opacity error read, rounded up (2 x 5e-4); at most
# MAX_TIE_SHARE of the window's hit rays may be near ties
TIE_MARGIN = 1e-3
MAX_TIE_SHARE = 0.25
# card vs CPU training step (bf16 decode), relative: the loss (read 1.1e-6
# vs control 8.3e-4), and each group of gradients, sum |card - CPU| /
# sum |CPU| over its leaves, on the state the timed steps leave (PERF.md
# §6, step 23: MLP read 2.1e-3 to 4.4e-3, control 6.2e-2 to 7.8e-2; points
# 9.0e-4 to 9.6e-4, control 7.4e-3 to 8.6e-3). No bar fits 10x under the
# control with room above the readings; these sit >= 2.3x over the highest
# reading and >= 3x under the least control.
LOSS_BF16_TOL = 1e-4
GRAD_BF16_TOL = {"mlp": 1e-2, "points": 2.5e-3}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_BF16 = 989e12             # dense bf16 tensor-core rate
PEAK_F32 = 67e12               # f32 outside the tensor cores

N_POINTS = 65536
N_RAYS = 3600
N_REQUESTS = 4
N_TRAIN_WARMUP = 3     # bench.py's step loop
N_TRAIN_STEPS = 20
TRAIN_KERNELS = ("knn_select", "fused_decode", "fused_decode_bwd")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """ms per call of back-to-back calls between two CUDA events: the
    device time of calls that outlast their host-side dispatch."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def graph_ms(fn, launches: int = 50, replays: int = 5) -> float:
    """Device ms per call of a short kernel: `launches` calls of `fn` are
    captured in one CUDA graph and its replays timed with CUDA events, so
    the wrapper's host time (checks, allocation, the ctypes call) is not in
    the reading. The wrappers launch on torch.cuda.current_stream(), which
    is the capture stream inside torch.cuda.graph."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                    # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(replays):
        g.replay()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / (replays * launches)


def host_us(fn, calls: int = 50) -> float:
    """Host µs per call of `fn` (enqueue only; the device catches up
    after)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def hold_bf16(what: str, err: float, control: float, bar: float,
              control_is: str = "f32 in place of bf16") -> None:
    """Fail unless the comparison is under its bar and the control (by
    default the f32 version in place of the bf16 one) is above it."""
    log(f"{what}: {err:.3e}, control ({control_is}) {control:.3e}, bar "
        f"{bar:.3e}")
    if not err <= bar:
        fail(f"{what} beyond its bar")
    if not control > bar:
        fail(f"{what}: the bar does not tell the control apart")


def hold_max(what: str, names, kern, plain, ref, f32_tol: float) -> None:
    """Fail unless each tensor's largest |kernel - plain| / max|plain| is
    within MAX_FACTOR x that of `ref` (the plain version summed in f64)
    + f32_tol."""
    rows = []
    for name, k, p, r in zip(names, kern, plain, ref):
        s = float(p.abs().max())
        ek = float((k - p).abs().max())
        er = float((r - p).abs().max())
        ek, er = ((ek / s, er / s) if s > 0
                  else (0.0 if ek == 0 else float("inf"), 0.0))
        rows.append((name, ek, er, MAX_FACTOR * er + f32_tol))
    log(f"{what}: largest |err| / max|plain| per tensor, kernel vs the "
        f"f64-summed plain version [bar]: " + ", ".join(
            f"{n} {ek:.3e} vs {er:.3e} [{bar:.3e}]" for n, ek, er, bar in rows))
    bad = [n for n, ek, _er, bar in rows if not ek <= bar]
    if bad:
        fail(f"{what}: the largest error of {bad} is beyond its bar")


def live_tiles(row_live, rows: int) -> str:
    """'n of N' tiles of `rows` rows that hold a live row."""
    import torch
    pad = -row_live.numel() % rows
    t = torch.nn.functional.pad(row_live.reshape(-1), (0, pad)).view(-1, rows)
    return f"{int(t.any(1).sum())} of {t.shape[0]}"


def mean_rel(a, b) -> float:
    """mean |a - b| / mean |b| (0 where b is all zero and a equals it)."""
    den = float(b.abs().mean())
    num = float((a - b).abs().mean())
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def bound_ms(nbytes: float, flops: float, peak: float):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def slice_config():
    from pointnerf_tpu_torch.config import bench_config
    cfg = bench_config()
    return cfg.replace(
        query=dataclasses.replace(cfg.query, knn_select="pallas"),
        agg=dataclasses.replace(cfg.agg, fused_decode=True),
        render=dataclasses.replace(cfg.render, fused_march=True))


def make_scene(cfg, device):
    import torch
    from pointnerf_tpu_torch.data.synthetic import sphere_scene
    from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
    from pointnerf_tpu_torch.models.points import make_point_cloud
    from pointnerf_tpu_torch.train.step import refresh_grid
    xyz, color, normals = sphere_scene(n_pts=N_POINTS, seed=0)
    pc, st = make_point_cloud(xyz, torch.Generator().manual_seed(0),
                              cfg.points, cfg.agg.point_features_dim,
                              color=color, dirs=normals, device=device)
    params = init_aggregator_params(cfg.agg, torch.Generator().manual_seed(1),
                                    device=device)
    grid, _max_d = refresh_grid(pc, st, cfg)
    return pc, st, params, grid


def batches(cfg, n_rays, n_views, device, seed0=1):
    from pointnerf_tpu_torch.data.synthetic import ring_cameras, view_ray_batch
    from pointnerf_tpu_torch.models.renderer import ray_batch_from_numpy
    out = []
    for i, (campos, camrot, K) in enumerate(
            ring_cameras(n_views=n_views, wh=(256, 256))):
        item = view_ray_batch(campos, camrot, K, (256, 256), n_rays=n_rays,
                              seed=seed0 + i)
        out.append(ray_batch_from_numpy(item, cfg, device=device))
    return out


# the kernels every render launches once (eval_step, not training)
RENDER_KERNELS = ("knn_select", "fused_decode", "fused_march")


@contextlib.contextmanager
def recording_kernels():
    """Recording wrappers around the three kernel entry points as the
    render path calls them; yields {name: (args, kwargs)} of each one's
    last call."""
    from pointnerf_tpu_torch.models import aggregator, renderer
    from pointnerf_tpu_torch.ops import query
    seen = {}
    spots = [(query, "knn_select"), (aggregator, "fused_decode"),
             (renderer, "fused_march")]
    originals = [(mod, attr, getattr(mod, attr)) for mod, attr in spots]
    for mod, attr, real in originals:
        def rec(*a, _name=attr, _real=real, **k):
            seen[_name] = (a, k)
            return _real(*a, **k)
        setattr(mod, attr, rec)
    try:
        yield seen
    finally:
        for mod, attr, real in originals:
            setattr(mod, attr, real)


def all_recorded(seen, what: str, kernels=RENDER_KERNELS):
    missing = [n for n in kernels if n not in seen]
    if missing:
        fail(f"{what} did not reach {missing}")
    return seen


def capture_kernel_inputs(params, pc, st, grid, batch, cfg):
    """Render one request with recording wrappers around the three kernel
    entry points; returns {name: (args, kwargs)} as the path called them."""
    from pointnerf_tpu_torch.train.step import eval_step
    with recording_kernels() as seen:
        eval_step({"mlp": params, "points": pc}, st, grid, batch, cfg)
    return all_recorded(seen, "the main path")


def k1_run_stats(nbr_xyz, dslot, ok, centers, r2: float, block: int):
    """What decides whether sharing a table row across a run of slots pays:
    the slots that select (ok and a row), the distinct rows they read, the
    runs of equal row among consecutive selecting slots (invalid slots in
    between do not end a run) and the runs a kernel that stages one row per
    run in each block of `block` slots reads; and what a row holds: its
    live candidates (x < 1e7) per row and per selecting slot, and those
    within r2 per slot."""
    import torch
    from pointnerf_tpu_torch.ops.knn_select import DEAD
    C, QP = dslot.shape[0], nbr_xyz.shape[1] // 3
    sel = ok & (dslot >= 0)
    idx = sel.nonzero()[:, 0]
    rows = dslot[idx].long()
    n = int(idx.numel())
    if n == 0:
        return {"slots": C, "selecting": 0}
    new_run = torch.ones_like(rows, dtype=torch.bool)
    new_run[1:] = rows[1:] != rows[:-1]
    # a run is cut where a block of slots ends
    blk = idx // block
    staged = new_run.clone()
    staged[1:] |= blk[1:] != blk[:-1]
    distinct = torch.unique(rows)
    live = (nbr_xyz[:, :QP] < DEAD).sum(1)              # per table row
    xyz = nbr_xyz[rows].view(n, 3, QP)
    d2 = ((xyz - centers[idx][:, :, None]) ** 2).sum(1)
    in_r = nbr_xyz[rows][:, :QP] < DEAD
    if r2 > 0:
        in_r &= d2 <= r2
    return {"slots": C, "selecting": n, "distinct_rows": int(distinct.numel()),
            "runs": int(new_run.sum()),
            "mean_run": n / int(new_run.sum()),
            "staged_runs": int(staged.sum()),
            "live_per_row": float(live[distinct].float().mean()),
            "live_per_slot": float(live[rows].float().mean()),
            "in_r2_per_slot": float(in_r.sum(1).float().mean())}


def check_k1(args, kw):
    import torch
    from pointnerf_tpu_torch.ops.knn_select import (SLOTS_PER_BLOCK,
                                                    knn_select,
                                                    knn_select_plain)
    nbr_xyz, nbr_pid, dslot, centers, ok = args
    K, r2 = kw["K"], kw["r2"]
    C, QP = centers.shape[0], nbr_pid.shape[1]
    st = k1_run_stats(nbr_xyz, dslot, ok, centers, r2, SLOTS_PER_BLOCK)
    log(f"K1 run statistics: {json.dumps(st)}")
    pid_k, d2_k = knn_select(*args, **kw)
    pid_p, d2_p = knn_select_plain(*args, K, r2)
    torch.cuda.synchronize()
    n_bad = int((pid_k != pid_p).sum())
    fin = torch.isfinite(d2_p)
    if not torch.equal(fin, torch.isfinite(d2_k)):
        fail("K1: kernel and plain disagree on which winners are valid")
    err = float((d2_k[fin] - d2_p[fin]).abs().max()) if fin.any() else 0.0
    log(f"K1 knn_select C={C} QP={QP} K={K}: pid mismatches {n_bad} "
        f"(must be 0), max |d2 err| {err:.3e} (must be 0)")
    if n_bad or err != 0.0:
        fail("K1 disagrees with its plain version")
    ms = graph_ms(lambda: knn_select(*args, **kw))
    host = host_us(lambda: knn_select(*args, **kw))
    plain = cuda_ms(lambda: knn_select_plain(*args, K, r2), iters=10)
    # bytes this run's data needs: each distinct table row read once
    # (coordinates + ids), the slots' centers/dslot/ok, the [C, K] outputs
    rows = st.get("distinct_rows", 0)
    nbytes = rows * QP * 16 + C * (12 + 4 + 1) + C * K * 8
    flops = st["selecting"] * QP * 8
    b, by = bound_ms(nbytes, flops, PEAK_F32)
    log(f"K1 device time {ms:.4f} ms (CUDA graph of 50 launches), wrapper "
        f"host time {host:.1f} us per call, plain {plain:.4f} ms, bound "
        f"{b:.4f} ms ({by}: {rows} distinct rows), library: none (no single "
        f"PyTorch call computes distance + masked K-selection)")
    return {"max_abs_err": err, "ms": ms, "host_us": host, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "run_stats": st}


def check_k2(args, kw):
    import torch
    from pointnerf_tpu_torch.ops.fused_march import (fused_march,
                                                     fused_march_plain)
    dist, valid, feats, bg = args
    R, SR = dist.shape
    outs_k = fused_march(*args)
    outs_p = fused_march_plain(*args)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(outs_k, outs_p))
    log(f"K2 fused_march R={R} SR={SR}: max abs err {err:.3e} "
        f"(tolerance {K2_TOL})")
    if not err <= K2_TOL:
        fail("K2 disagrees with its plain version")
    ms = graph_ms(lambda: fused_march(*args))
    host = host_us(lambda: fused_march(*args))
    plain = cuda_ms(lambda: fused_march_plain(*args), iters=5)
    C = feats.shape[-1] - 1
    nbytes = R * SR * (4 + 1 + 4 * (C + 1)) + 4 * C \
        + R * C * 4 + R * SR * 4 + R * 4
    flops = R * SR * (6 + 3 * C)
    b, by = bound_ms(nbytes, flops, PEAK_F32)
    log(f"K2 device time {ms:.4f} ms (CUDA graph of 50 launches), wrapper "
        f"host time {host:.1f} us per call, plain {plain:.4f} ms, bound "
        f"{b:.4f} ms ({by}), library: none (no single PyTorch call "
        f"composites)")
    return {"max_abs_err": err, "ms": ms, "host_us": host, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": None}


def check_k3(captured, what: str = "request"):
    """K3 against its plain version on the decode inputs of every captured
    `what` (a request, a probe chunk or an eval chunk), in bf16 and in f32;
    times and bound on the first one's."""
    import torch
    from pointnerf_tpu_torch.ops.fused_decode import (TC_ROWS, flops,
                                                      fused_decode,
                                                      fused_decode_plain,
                                                      route)

    def diff(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    def worst_mean(a, b):
        return max(mean_rel(x, y) for x, y in zip(a, b))
    errs = {"bf16": 0.0, "f32": 0.0}
    rel, control = 0.0, float("inf")
    for i, (args, _kw) in enumerate(captured):
        feat, dists, extras, w, params, spec = args
        plain = {label: fused_decode_plain(feat, dists, extras, w, params,
                                           spec._replace(bf16=label == "bf16"))
                 for label in errs}
        for label, tol in (("bf16", K3_BF16_TOL), ("f32", K3_F32_TOL)):
            sp = spec._replace(bf16=label == "bf16")
            out = fused_decode(feat, dists, extras, w, params, sp)
            torch.cuda.synchronize()
            scale = max(float(t.abs().max()) for t in plain[label])
            if not scale > 0:
                fail(f"K3 ({label}): the plain decode is all zero")
            err = diff(out, plain[label])
            errs[label] = max(errs[label], err)
            if label == "bf16":
                m = worst_mean(out, plain[label])
                log(f"K3 fused_decode bf16, {what} {i}, M={feat.shape[0]} "
                    f"H={sp.H}: mean |err| / mean |plain| {m:.3e} (worst "
                    f"output), max abs err {err:.3e}")
                # the order-independent reference: the plain version with
                # its sums in f64, the same rounding points
                hold_max(f"K3 bf16, {what} {i}", ("fagg", "alpha"), out,
                         plain[label],
                         fused_decode_plain(feat, dists, extras, w, params,
                                            sp, dtype=torch.float64),
                         K3_F32_TOL)
                rel = max(rel, m)
                control = min(control, worst_mean(plain["f32"],
                                                  plain["bf16"]))
            else:
                log(f"K3 fused_decode f32, {what} {i}, M={feat.shape[0]} "
                    f"H={sp.H}: max abs err {err:.3e}, scale max|plain| "
                    f"{scale:.3e} (tolerance {tol} x scale)")
                if not err <= tol * scale:
                    fail(f"K3 ({label}) disagrees with its plain version")
    hold_bf16(f"K3 bf16 vs plain over {len(captured)} {what}s, mean |err| / "
              f"mean |plain|, worst output", rel, control, K3_BF16_TOL)

    feat, dists, extras, w, params, spec = captured[0][0]
    M = feat.shape[0]
    res = {}
    for label in errs:
        sp = spec._replace(bf16=label == "bf16")
        ms = cuda_ms(lambda: fused_decode(feat, dists, extras, w, params, sp),
                     iters=5, warmup=1)
        plain_ms = cuda_ms(lambda: fused_decode_plain(feat, dists, extras, w,
                                                      params, sp),
                           iters=3, warmup=1)
        # rows this run's data needs: those with a nonzero weight
        rows = int((w != 0).sum())
        wbytes = sum(p.numel() * 4 for n in ("block1", "block3", "alpha")
                     for layer in params[n] for p in layer.values())
        nbytes = rows * (sp.Fi + sp.Dd + sp.E + 1) * 4 + wbytes \
            + (M // sp.K) * (sp.H + 1) * 4
        b, by = bound_ms(nbytes, flops(rows, sp),
                         PEAK_BF16 if sp.bf16 else PEAK_F32)
        log(f"K3 {label} ({route(sp)} kernel) time {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b:.4f} ms ({by}: {rows} of {M} rows "
            f"carry weight; tiles of {TC_ROWS} rows with weight: "
            f"{live_tiles(w != 0, TC_ROWS)}), library: none (no single "
            f"PyTorch call computes the decode)")
        res[label] = {"max_abs_err": errs[label], "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                      "library_ms": None}
    chain = gemm_chain_ms(spec, rows, backward=False)
    log(f"K3 yardstick (printed only, never called by the port): the same "
        f"layer products over {rows} rows as a bf16 torch.matmul chain "
        f"{chain:.4f} ms")
    res["bf16"]["gemm_chain_ms"] = chain
    return res


def gemm_chain_ms(spec, rows: int, backward: bool) -> float:
    """Time of the decode's layer products for `rows` rows as a chain of
    bf16 torch.matmul calls (cuBLAS): the forward's h = x W per layer, and
    with `backward` also g_h = g_z W^T and dW = act^T g_z per layer. A
    yardstick for K3 and K4 only: the port never calls it."""
    import torch
    from pointnerf_tpu_torch.ops.fused_decode import layer_inputs
    g = torch.Generator(device="cuda").manual_seed(0)
    ins = layer_inputs(spec)
    Ws = [torch.randn((n, spec.H), generator=g, device="cuda",
                      dtype=torch.bfloat16) for n in ins]
    x = torch.randn((rows, max(ins)), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    gz = torch.randn((rows, spec.H), generator=g, device="cuda",
                     dtype=torch.bfloat16)

    def run():
        for n, W in zip(ins, Ws):
            torch.matmul(x[:, :n], W)
        if backward:
            for n, W in zip(ins, Ws):
                torch.matmul(gz, W.t())
                torch.matmul(x[:, :n].t(), gz)
    return cuda_ms(run, iters=5, warmup=2)


def kernel_wrappers():
    """{name: wrapper}; each wrapper counts its kernel launches in
    `.launches`."""
    from pointnerf_tpu_torch.ops.fused_decode import (fused_decode,
                                                      fused_decode_bwd)
    from pointnerf_tpu_torch.ops.fused_march import fused_march
    from pointnerf_tpu_torch.ops.knn_select import knn_select
    return {"knn_select": knn_select, "fused_decode": fused_decode,
            "fused_march": fused_march, "fused_decode_bwd": fused_decode_bwd}


def main_path(params, pc, st, grid, reqs, cfg):
    import torch
    from pointnerf_tpu_torch.train.step import eval_step
    kernels = kernel_wrappers()
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for i, batch in enumerate(reqs):
        before = {n: k.launches for n, k in kernels.items()}
        out = eval_step({"mlp": params, "points": pc}, st, grid, batch, cfg)
        outs.append(out)
        for n, k in kernels.items():
            if n != "fused_decode_bwd" and k.launches <= before[n]:
                fail(f"request {i}: {n} was not launched")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {n: k.launches for n, k in kernels.items()}
    for i, out in enumerate(outs):
        col = out.coarse_raycolor
        if col.shape != (N_RAYS, 3) or not bool(torch.isfinite(col).all()):
            fail(f"request {i}: colors not finite or of shape {col.shape}")
        log(f"request {i}: rays hit {int(out.ray_mask.sum())}/{N_RAYS}, "
            f"decode_dropped {int(out.decode_dropped)}")
    n = len(reqs) * N_RAYS
    routes = kernel_routes(kernels, "serving")
    log(f"serving path: {len(reqs)} requests x {N_RAYS} rays in {dt:.4f} s = "
        f"{n / dt:.1f} rays/s (host clock, synchronized), launches {counts}, "
        f"routes {routes}")
    return counts, routes


def reset_counts(kernels):
    from pointnerf_tpu_torch.ops.fused_decode import reset_launches
    for k in kernels.values():
        k.launches = 0
    reset_launches()
    routes = kernels["knn_select"].launches_by_route
    routes.update(dict.fromkeys(routes, 0))


# the route every launch of a main path takes: the decode kernels on the
# tensor cores (the main paths decode in bf16), K1 on its run path (K = 8)
MAIN_ROUTES = {"knn_select": "runs", "fused_decode": "tensor_core",
               "fused_decode_bwd": "tensor_core"}


def kernel_routes(kernels, path: str):
    """The launches of a main-path run by route; fails unless every one
    went to the route of MAIN_ROUTES."""
    routes = {n: dict(kernels[n].launches_by_route) for n in MAIN_ROUTES}
    for n, r in routes.items():
        if r[MAIN_ROUTES[n]] != kernels[n].launches \
                or sum(r.values()) != kernels[n].launches:
            fail(f"{path} path: {n} launches went to another route than "
                 f"{MAIN_ROUTES[n]}: {r}")
    return routes


def same_integers(o_card, o_cpu):
    """Fail unless two renders agree on every integer output."""
    import torch
    for f in ("ray_valid", "ray_mask", "decode_dropped"):
        if not torch.equal(getattr(o_card, f).cpu(), getattr(o_cpu, f)):
            fail(f"{f} differs between the card and the CPU")
    pk, pc_ = o_card.neighbor_pidx.cpu(), o_cpu.neighbor_pidx
    bad_rows = (pk != pc_).any(-1).nonzero()[:, 0].tolist()
    if bad_rows:
        # an equal id set in another order can only come from a d2 tie
        for r in bad_rows[:20]:
            tie = sorted(pk[r].tolist()) == sorted(pc_[r].tolist())
            log(f"  slot {r}: card {pk[r].tolist()} cpu {pc_[r].tolist()} "
                f"({'same set: a d2 tie' if tie else 'different sets'})")
        fail(f"neighbor ids differ between the card and the CPU in "
             f"{len(bad_rows)} slots")


def cpu_parity(params, pc, st, grid, cfg, cfg_cpu=None, b_card=None,
               bar=COLOR_BF16_TOL):
    """One 512-ray request on the card and on the CPU (plain versions); the
    control renders it on the CPU with an f32 decode. `cfg_cpu` (default
    `cfg`) is the CPU side's config: with the fused flags set it runs the
    kernels' plain versions, which the card's kernels follow whatever the
    flags say. `b_card` (default a ring view's 512 rays) is the request.
    Integers must be equal and the colors of the rays that hit within
    `bar`."""
    cfg_cpu = cfg_cpu or cfg
    import torch
    from pointnerf_tpu_torch.ops.grid import build_grid
    from pointnerf_tpu_torch.train.step import eval_step
    cpu = torch.device("cpu")
    mv = lambda t: t.to(cpu)  # noqa: E731
    pc_c = type(pc)(*[mv(t) for t in pc])
    st_c = type(st)(*[mv(t) for t in st])
    params_c = {k: [{n: mv(t) for n, t in layer.items()} for layer in v]
                for k, v in params.items()}
    q = dataclasses.replace(cfg.query, max_d=grid.nbr_pid.shape[0])
    grid_c = build_grid(pc_c.xyz, st_c.num_active, q)
    for f in ("vox_dslot", "nbr_pid", "nbr_xyz", "vox_occ"):
        if not torch.equal(getattr(grid_c, f), mv(getattr(grid, f))):
            fail(f"grid table {f} differs between the card and the CPU")
    if b_card is None:
        b_card = batches(cfg, 512, 1, "cuda", seed0=7)[0]
    b_cpu = type(b_card)(*[None if t is None else mv(t) for t in b_card])
    o_card = eval_step({"mlp": params, "points": pc}, st, grid, b_card, cfg)
    o_cpu = eval_step({"mlp": params_c, "points": pc_c}, st_c, grid_c, b_cpu,
                      cfg_cpu)
    same_integers(o_card, o_cpu)
    cfg32 = cfg_cpu.replace(train=dataclasses.replace(cfg_cpu.train,
                                                      compute_dtype="f32"))
    o_ctl = eval_step({"mlp": params_c, "points": pc_c}, st_c, grid_c, b_cpu,
                      cfg32)
    hit = o_cpu.ray_mask
    col = mv(o_card.coarse_raycolor)[hit]
    log(f"card vs CPU, 512 rays: integers equal, neighbor-id mismatches 0, "
        f"{int(hit.sum())} rays hit")
    if not bool(hit.any()):
        fail("no ray of the parity request hits the scene")
    err = float((col - o_cpu.coarse_raycolor[hit]).abs().max())
    ctl = float((col - o_ctl.coarse_raycolor[hit]).abs().max())
    hold_bf16("card vs CPU colors of the rays that hit", err, ctl, bar)


def capture_k4_inputs(state, st, grid, batch, cfg):
    """Take one training step with a recording wrapper around K4's entry
    point; returns its arguments as the step's backward called it."""
    from pointnerf_tpu_torch.ops import fused_decode as fd
    from pointnerf_tpu_torch.train.step import train_step
    real, seen = fd.fused_decode_bwd, []

    def rec(*a, **k):
        seen.append(a)
        fd.fused_decode_bwd = real      # the wrapper counts on its own name
        return real(*a, **k)
    fd.fused_decode_bwd = rec
    try:
        train_step(state, st, grid, batch, cfg)
    finally:
        fd.fused_decode_bwd = real
    if len(seen) != 1:
        fail(f"a training step called the decode backward {len(seen)} times")
    return seen[0]


@contextlib.contextmanager
def recording_decode():
    """Recording wrappers around K3's entry point (as the aggregator calls
    it) and K4's (as the autograd Function's backward calls it); yields
    {"fused_decode": args, "fused_decode_bwd": args} of the last calls."""
    from pointnerf_tpu_torch.models import aggregator
    from pointnerf_tpu_torch.ops import fused_decode as fd
    seen = {}
    real_fwd, real_bwd = aggregator.fused_decode, fd.fused_decode_bwd

    def fwd(*a, **k):
        seen["fused_decode"] = a
        return real_fwd(*a, **k)

    def bwd(*a, **k):
        seen["fused_decode_bwd"] = a
        fd.fused_decode_bwd = real_bwd  # the wrapper counts on its own name
        try:
            return real_bwd(*a, **k)
        finally:
            fd.fused_decode_bwd = bwd
    aggregator.fused_decode, fd.fused_decode_bwd = fwd, bwd
    try:
        yield seen
    finally:
        aggregator.fused_decode, fd.fused_decode_bwd = real_fwd, real_bwd


def decode_grad_leaves(out):
    """(names, tensors) of a decode backward's result: the row gradients,
    then every dW/db in parameter order."""
    g_feat, g_dists, g_extras, g_w, gp = out
    names = ["g_feat", "g_dists", "g_extras", "g_w"]
    leaves = [g_feat, g_dists, g_extras, g_w]
    for blk in ("block1", "block3", "alpha"):
        for i, layer in enumerate(gp[blk]):
            for n in ("w", "b"):
                names.append(f"d{blk}[{i}].{n}")
                leaves.append(layer[n])
    return names, leaves


def check_k4(args):
    """K4 against its plain version on the inputs of a real training step,
    in bf16 and in f32, on the row gradients and every dW/db (each relative
    to its own max|plain|); times and bound in each precision."""
    import torch
    from pointnerf_tpu_torch.ops.fused_decode import (TC_ROWS_BWD, flops,
                                                      fused_decode_bwd,
                                                      fused_decode_bwd_plain,
                                                      layer_inputs,
                                                      param_count, route)
    feat, dists, extras, w, params, spec, g_fagg, g_alpha = args
    M = feat.shape[0]

    def run(fn, bf16):
        return decode_grad_leaves(fn(feat, dists, extras, w, params,
                                     spec._replace(bf16=bf16), g_fagg,
                                     g_alpha))

    def rel(a_list, b_list):
        out = []
        for a, b in zip(a_list, b_list):
            scale = float(b.abs().max())
            if not scale > 0:
                fail("K4: a gradient of the plain backward is all zero")
            out.append(float((a - b).abs().max()) / scale)
        return out

    def worst(errs):
        i = max(range(len(errs)), key=errs.__getitem__)
        return errs[i], names[i]

    res = {}
    with torch.no_grad():
        names, plain32 = run(fused_decode_bwd_plain, False)
        _, plain16 = run(fused_decode_bwd_plain, True)
        control = max(mean_rel(a, b) for a, b in zip(plain32, plain16))
        for label, plain in (("bf16", plain16), ("f32", plain32)):
            _, out = run(fused_decode_bwd, label == "bf16")
            torch.cuda.synchronize()
            mx, mx_name = worst(rel(out, plain))
            abs_err = max(float((a - b).abs().max())
                          for a, b in zip(out, plain))
            if label == "bf16":
                m, m_name = worst([mean_rel(a, b) for a, b in zip(out, plain)])
                log(f"K4 fused_decode_bwd bf16, M={M} H={spec.H}: mean "
                    f"|err| / mean |plain| {m:.3e} (worst gradient: {m_name}); "
                    f"max abs err {abs_err:.3e}, {mx:.3e} of its gradient's "
                    f"max|plain| ({mx_name})")
                hold_bf16("K4 bf16 vs plain, mean |err| / mean |plain|, worst "
                          "gradient", m, control, K4_BF16_TOL)
                _, plain64 = decode_grad_leaves(fused_decode_bwd_plain(
                    feat, dists, extras, w, params, spec, g_fagg, g_alpha,
                    dtype=torch.float64))
                hold_max("K4 bf16", names, out, plain, plain64, K4_F32_TOL)
                del plain64
            else:
                log(f"K4 fused_decode_bwd f32, M={M} H={spec.H}: max abs "
                    f"err {abs_err:.3e}, max err relative to its gradient's "
                    f"max|plain| {mx:.3e} ({mx_name})")
                if not mx <= K4_F32_TOL:
                    fail("K4 (f32) disagrees with its plain version")
            res[label] = {"max_abs_err": abs_err}
        del plain32, plain16, out

        # rows this run's data needs: those with a nonzero weight (a row
        # without weight has all-zero gradients); all M gradient rows are
        # written
        rows = int((w != 0).sum())
        wbytes = sum(p.numel() * 4 for n in ("block1", "block3", "alpha")
                     for layer in params[n] for p in layer.values())
        width = spec.Fi + spec.Dd + spec.E + 1
        nbytes = (rows * width * 4 + M * 4 + wbytes
                  + (M // spec.K) * (spec.H + 1) * 4
                  + M * width * 4 + param_count(spec) * 4)
        # a cost of the tensor-core K4's design, not of its function (so not
        # in the bound): its second phase takes dW from every live row's
        # layer inputs and g_z (bf16), written to device memory once and
        # read once
        phase_b = rows * 2 * 2 * (sum(layer_inputs(spec))
                                  + (spec.L1 + spec.L3) * spec.H)
        # K4's tiles that are computed: a live row, or a live upstream
        # gradient on the tile's groups
        live = ((w != 0).view(-1)
                | ((g_fagg != 0).any(1) | (g_alpha != 0).view(-1))
                .repeat_interleave(spec.K))
        log(f"K4 tiles of {TC_ROWS_BWD} rows computed (not dead): "
            f"{live_tiles(live, TC_ROWS_BWD)}")
        for label in res:
            sp = spec._replace(bf16=label == "bf16")
            ms = cuda_ms(lambda: fused_decode_bwd(feat, dists, extras, w,
                                                  params, sp, g_fagg,
                                                  g_alpha),
                         iters=3, warmup=1)
            plain_ms = cuda_ms(lambda: fused_decode_bwd_plain(
                feat, dists, extras, w, params, sp, g_fagg, g_alpha),
                iters=3, warmup=1)
            # the forward again, dW, and the input gradients: 3 x K3's
            b, by = bound_ms(nbytes, 3 * flops(rows, sp),
                             PEAK_BF16 if sp.bf16 else PEAK_F32)
            log(f"K4 {label} ({route(sp)} kernel) time {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {b:.4f} ms ({by}: {rows} of {M} "
                f"rows carry weight; bytes alone "
                f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms), library: none "
                f"(no single PyTorch call computes the decode backward)")
            if sp.bf16:
                log(f"K4 bf16 design cost, outside the bound: phase B moves "
                    f"{phase_b / 1e9:.3f} GB of bf16 layer inputs and g_z "
                    f"through device memory, "
                    f"{phase_b / HBM_BYTES_PER_S * 1e3:.4f} ms at "
                    f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")
            res[label].update({"ms": ms, "plain_ms": plain_ms,
                               "bound_ms": b, "bound_by": by,
                               "library_ms": None})
        a = fused_decode_bwd(feat, dists, extras, w, params, spec, g_fagg,
                             g_alpha)
        b2 = fused_decode_bwd(feat, dists, extras, w, params, spec, g_fagg,
                              g_alpha)
        same = all(torch.equal(x, y) for x, y in
                   zip(decode_grad_leaves(a)[1], decode_grad_leaves(b2)[1]))
        log(f"K4 bf16: two calls on the same inputs give the same bits in "
            f"every gradient: {same}")
        if not same:
            fail("K4 (bf16) is not deterministic run to run")
        del a, b2
    chain = gemm_chain_ms(spec, rows, backward=True)
    log(f"K4 yardstick (printed only, never called by the port): the same "
        f"layer products (forward, g_z W^T, act^T g_z) over {rows} rows as a "
        f"bf16 torch.matmul chain {chain:.4f} ms")
    res["bf16"]["gemm_chain_ms"] = chain
    return res


def train_path(state, st, grid, batch, cfg):
    """bench.py's loop: 3 warm-up and 20 timed train steps on one batch.
    Every step must launch K1, K3 and K4 once each; the loss must be finite
    and fall. Returns (launch counts, final state)."""
    import torch
    from pointnerf_tpu_torch.train.step import train_step
    kernels = kernel_wrappers()
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, dropped = [], []
    for i in range(N_TRAIN_WARMUP + N_TRAIN_STEPS):
        if i == N_TRAIN_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = {n: kernels[n].launches for n in TRAIN_KERNELS}
        state, items = train_step(state, st, grid, batch, cfg)
        for n in TRAIN_KERNELS:
            if kernels[n].launches != before[n] + 1:
                fail(f"train step {i}: {n} launched "
                     f"{kernels[n].launches - before[n]} times, not once")
        losses.append(items["loss_total"])
        dropped.append(items["n_decode_dropped"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {n: k.launches for n, k in kernels.items()}
    routes = kernel_routes(kernels, "training")
    if counts["fused_march"]:
        fail("training launched the fused march (JAX trains through the "
             "plain march)")
    losses = torch.stack(losses).cpu()
    if not bool(torch.isfinite(losses).all()):
        fail(f"a training loss is not finite: {losses.tolist()}")
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    log(f"train losses {[round(float(v), 6) for v in losses]}")
    log(f"train: mean loss of the first 5 steps {first:.6f}, of the last 5 "
        f"{last:.6f}; decode_dropped per step "
        f"{sorted(set(int(d) for d in dropped))}")
    if not last < first:
        fail("the training loss did not fall")
    rate = N_TRAIN_STEPS * N_RAYS / dt
    log(f"train path: {N_TRAIN_STEPS} steps x {N_RAYS} rays after "
        f"{N_TRAIN_WARMUP} warm-up steps in {dt:.4f} s = {rate:.1f} train "
        f"rays/s (fwd + bwd + Adam, host clock, synchronized), launches "
        f"{counts}, routes {routes}")
    return counts, routes, state


def named_leaves(tree, name=""):
    """(path, leaf) of a gradient tree in tree_leaves order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in named_leaves(tree[k], f"{name}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{name}[{i}]")]
    return [(name, tree)]


def train_grads(state, st, grid, cfg, seed0: int = 11):
    """The loss and gradients of one 512-ray training step from `state` on
    the card and on the CPU (plain versions), with the same jitter draw, and
    the control: the CPU with an f32 decode. Fails unless the card and the
    CPU agree on every integer. Returns {"card" | "cpu" | "control": (loss,
    grads)}."""
    import torch
    from pointnerf_tpu_torch.models.renderer import render_rays
    from pointnerf_tpu_torch.train.optim import tree_map
    from pointnerf_tpu_torch.train.step import loss_and_grads
    cpu = torch.device("cpu")
    params_c = tree_map(lambda t: t.to(cpu), state.params)
    st_c = type(st)(*[t.to(cpu) for t in st])
    grid_c = type(grid)(*[None if t is None else t.to(cpu) for t in grid])
    dev = state.step.device
    b_card = batches(cfg, 512, 1, dev, seed0=seed0)[0]
    b_cpu = type(b_card)(*[None if t is None else t.to(cpu) for t in b_card])
    u = torch.rand((512, cfg.query.z_depth_dim),
                   generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        o_card = render_rays(state.params["mlp"], state.params["points"], st,
                             grid, b_card, cfg, train=True, u=u.to(dev))
        o_cpu = render_rays(params_c["mlp"], params_c["points"], st_c, grid_c,
                            b_cpu, cfg, train=True, u=u)
    same_integers(o_card, o_cpu)
    t_card, i_card, g_card = loss_and_grads(state.params, st, grid, b_card,
                                            cfg, u=u.to(dev))
    t_cpu, i_cpu, g_cpu = loss_and_grads(params_c, st_c, grid_c, b_cpu, cfg,
                                         u=u)
    cfg32 = cfg.replace(train=dataclasses.replace(cfg.train,
                                                  compute_dtype="f32"))
    t_ctl, _i, g_ctl = loss_and_grads(params_c, st_c, grid_c, b_cpu, cfg32,
                                      u=u)
    for k in ("n_miss", "n_decode_dropped"):
        if int(i_card[k]) != int(i_cpu[k]):
            fail(f"train step: {k} differs between the card and the CPU")
    log(f"card vs CPU train step, 512 rays (batch seed {seed0}): integers "
        f"equal, {int(o_cpu.ray_mask.sum())} rays hit, loss "
        f"{float(t_cpu):.6f}")
    return {"card": (t_card, g_card), "cpu": (t_cpu, g_cpu),
            "control": (t_ctl, g_ctl)}


def grad_readings(grads, ref):
    """Per group of a gradient tree (mlp, points) against `ref`'s: the
    group's sum |g - ref| / sum |ref| over all its leaves, and its worst
    leaf's mean |g - ref| / mean |ref| and max |g - ref| / max |ref|, each
    as (value, leaf name)."""
    from pointnerf_tpu_torch.train.optim import tree_leaves
    out = {}
    for grp in ("mlp", "points"):
        num = den = 0.0
        worst_mean, worst_max = (0.0, ""), (0.0, "")
        for a, (name, b) in zip(tree_leaves(grads[grp]),
                                named_leaves(ref[grp])):
            a = a.to(b.device)
            num += float((a - b).abs().sum())
            den += float(b.abs().sum())
            scale = float(b.abs().max())
            if scale == 0:
                if float(a.abs().max()) != 0:
                    fail(f"train step: gradient {grp}{name} is zero on the "
                         f"CPU only")
                continue
            worst_mean = max(worst_mean, (mean_rel(a, b), grp + name))
            worst_max = max(worst_max,
                            (float((a - b).abs().max()) / scale, grp + name))
        out[grp] = (num / den, worst_mean, worst_max)
    return out


def train_cpu_parity(state, st, grid, cfg):
    """The loss and gradients of one 512-ray training step on the card
    against the CPU's, each beside its control (the CPU with an f32
    decode)."""
    r = train_grads(state, st, grid, cfg)
    (t_card, g_card), (t_cpu, g_cpu), (t_ctl, g_ctl) = (
        r["card"], r["cpu"], r["control"])
    hold_bf16("card vs CPU train loss, relative",
              abs(float(t_card) - float(t_cpu)) / abs(float(t_cpu)),
              abs(float(t_ctl) - float(t_cpu)) / abs(float(t_cpu)),
              LOSS_BF16_TOL)
    card, ctl = grad_readings(g_card, g_cpu), grad_readings(g_ctl, g_cpu)
    for grp in ("mlp", "points"):
        (l1, (m, m_leaf), (mx, mx_leaf)), (c_l1, (cm, _), (cmx, _)) = (
            card[grp], ctl[grp])
        log(f"card vs CPU {grp} gradients (printed only): worst leaf's mean "
            f"|err| / mean |CPU| {m:.3e} ({m_leaf}; control {cm:.3e}), "
            f"worst leaf's max |err| / max|CPU| {mx:.3e} ({mx_leaf}; control "
            f"{cmx:.3e})")
        hold_bf16(f"card vs CPU {grp} gradients, sum |err| / sum |CPU| over "
                  f"the group's leaves", l1, c_l1, GRAD_BF16_TOL[grp])


# ---- the maintenance path: train_scene with prune, grow, split, eval and
# a checkpoint, then a resume -------------------------------------------
MAINT_STEPS = 40
MAINT_RESUME_TO = 44
MAINT_WH = (256, 256)
MAINT_VIEWS = 8
# the points within this angle of the probe view's silhouette are cut: a
# grazing ray then passes r (1 - cos 25 deg) = 0.047 from the nearest point
# left, beyond the KNN radius (4 voxels of 0.008), so it misses
SILHOUETTE_BAND_DEG = 25.0


def maintenance_config(cfg):
    """slice_config with a schedule that fires every maintenance event
    within MAINT_STEPS steps of 3,600 rays: prunes at 10/20/30/40, probes at
    15/30, splits at 20/40, an eval at 35, a checkpoint at 25 (and the final
    one at 40)."""
    # the weights are random, so the probe's peak opacities are not on a
    # trained scene's scale (the run prints them) and the reference's 0.7
    # would decide nothing: with prob_thresh 0 every hit ray next to a hole
    # grows (the threshold test itself is held against JAX on the CPU,
    # tests/test_torch_driver.py)
    return cfg.replace(train=dataclasses.replace(
        cfg.train, maximum_step=MAINT_STEPS, prune_iter=10,
        prune_max_iter=MAINT_STEPS, prune_thresh=0.1, prob_freq=15,
        prob_num_step=1, prob_thresh=0.0, split_iter=20, split_top=1024,
        test_freq=35, save_iter_freq=25, print_freq=5,
        random_sample_size=60))


def maintenance_scene():
    """The 65,536-point sphere_scene (seed 0) with a band around the probe
    view's silhouette cut away, every 8th remaining point's conf below
    prune_thresh (0.05; the rest 0.5), and the ring of MAINT_VIEWS views:
    training batches of 3,600 rays from every view, the probe frame is view
    0, the test frame view 4."""
    import numpy as np
    from pointnerf_tpu_torch.data.synthetic import (ring_cameras, sphere_scene,
                                                    view_ray_batch)
    xyz, color, normals = sphere_scene(n_pts=N_POINTS, seed=0)
    views = ring_cameras(n_views=MAINT_VIEWS, wh=MAINT_WH)
    d = float(np.linalg.norm(views[0][0]))
    ang = np.arccos(np.clip(normals @ (views[0][0] / d), -1.0, 1.0))
    keep = np.abs(ang - np.arccos(0.5 / d)) > np.radians(SILHOUETTE_BAND_DEG)
    xyz, color, normals = xyz[keep], color[keep], normals[keep]
    conf = np.full((xyz.shape[0], 1), 0.5, np.float32)
    conf[::8] = 0.05

    def train_item(step):
        v = step % MAINT_VIEWS
        return view_ray_batch(*views[v], MAINT_WH, n_rays=N_RAYS, seed=step,
                              view_id=v)
    probe = [view_ray_batch(*views[0], MAINT_WH, view_id=0)]
    test = [view_ray_batch(*views[4], MAINT_WH, view_id=4)]
    return (xyz, color, normals), conf, train_item, probe, test


class MaintRecorder:
    """Wraps the driver's and grow module's entry points for one run of
    train_scene: times each event on the device's clock (synchronized),
    checks what each event did against the state just before it, counts
    each train step's and each rendered chunk's kernel launches, and
    records the K1, K3 and K2 inputs of one dense probe chunk and of one
    eval chunk."""

    def __init__(self, cfg, kernels, train_kernels=TRAIN_KERNELS,
                 render_kernels=RENDER_KERNELS, record_step=None):
        import torch
        from pointnerf_tpu_torch.train import driver as td, grow as tg
        self.torch, self.td, self.tg = torch, td, tg
        self.cfg, self.kernels = cfg, kernels
        # the kernels each train step and each rendered chunk launch once
        self.train_kernels, self.render_kernels = train_kernels, render_kernels
        # the train step (1-based) whose K3 and K4 inputs are recorded
        self.record_step = record_step
        self.step_inputs = None   # {"fused_decode": args, "fused_decode_bwd": args}
        self.times = {k: [] for k in ("prune", "probe_frame", "grow", "split",
                                      "grid_refresh", "eval_frame",
                                      "checkpoint_save", "checkpoint_load",
                                      "train_step")}
        self.log = []            # (event, detail) in order
        self.maps = None         # the first probe frame's maps
        self.probe_item = None
        self.first_probe = None  # (params, st, grid) the first probe saw
        # {"probe_chunk" | "eval_chunk": {kernel: (args, kwargs)}}
        self.captured = {}
        self.saved = None        # the state the last checkpoint holds
        self.losses = []
        self._orig = []
        self._chunk = self._chunks = 0   # the chunk of the frame rendering

    def _patch(self, mod, name, fn):
        self._orig.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def restore(self):
        for mod, name, real in reversed(self._orig):
            setattr(mod, name, real)
        self._orig.clear()

    def _timed(self, key, fn, *a, **k):
        torch = self.torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        self.times[key].append(time.perf_counter() - t0)
        return out

    def install(self):
        td, tg = self.td, self.tg
        for name in ("apply_prune", "probe_hole", "apply_grow",
                     "split_high_grad", "refresh_grid", "train_step",
                     "save_checkpoint", "load_checkpoint",
                     "render_full_frame"):
            self._patch(td, name, getattr(self, name)(getattr(td, name)))
        self._patch(tg, "render_full_frame",
                    self.probe_frame(tg.render_full_frame))
        self._patch(tg, "eval_step", self.chunk(tg.eval_step))

    # -- events ---------------------------------------------------------
    def apply_prune(self, real):
        def run(state, st, cfg):
            n = int(st.num_active)
            conf = state.params["points"].conf[:n, 0]
            expect = int((conf > cfg.train.prune_thresh).sum())
            state, st, kept = self._timed("prune", real, state, st, cfg)
            if kept != expect or int(st.num_active) != expect:
                fail(f"prune kept {kept} of {n} points; {expect} had conf > "
                     f"{cfg.train.prune_thresh}")
            self.log.append(("prune", (n, kept)))
            return state, st, kept
        return run

    def probe_hole(self, real):
        def run(params, st, grid, *a, **k):
            if self.first_probe is None:
                self.first_probe = (params, st, grid)
            cand = real(params, st, grid, *a, **k)
            self.log.append(("probe", cand.xyz.shape[0]))
            return cand
        return run

    def probe_frame(self, real):
        def run(params, st, grid, cfg, item, wh, chunk=2304, prob=True):
            self._chunk = 0
            self._chunks = -(-len(item["raydir"]) // chunk)
            maps = self._timed("probe_frame", real, params, st, grid, cfg,
                               item, wh, chunk, prob)
            import numpy as np
            W, H = wh
            gt = np.zeros((H, W, 3), np.float32)
            pix = np.asarray(item["pixel_idx"], np.int64)
            gt[pix[:, 1], pix[:, 0]] = item["gt_image"]
            bg = np.asarray(cfg.render.bg_color, np.float32)
            miss = (~maps["ray_mask"][..., 0]
                    & (np.linalg.norm(gt - bg, axis=-1) > 0.002))
            self.log.append(("probe_frame", int(miss.sum())))
            peak = maps["ray_max_shading_opacity"][maps["ray_mask"][..., 0]]
            log(f"probe frame: {int(miss.sum())} rays miss where the ground "
                f"truth is the sphere; peak opacity of the hit rays: max "
                f"{float(peak.max()):.4f}, median "
                f"{float(np.median(peak)):.4f}")
            if self.maps is None:
                self.maps, self.probe_item = maps, item
                if not miss.any():
                    fail("the first probe frame has no hole: no ray misses "
                         "the cloud where the ground truth is the sphere")
            return maps
        return run

    def render_full_frame(self, real):
        def run(params, st, grid, cfg, item, wh, chunk=2304, prob=True):
            self._chunk = 0
            self._chunks = -(-len(item["raydir"]) // chunk)
            return self._timed("eval_frame", real, params, st, grid, cfg,
                               item, wh, chunk, prob)
        return run

    def chunk(self, real):
        """Every rendered chunk (probe or eval) launches K1, K3 and K2 once
        each; the middle chunk of the first probe frame and of the first
        eval frame records the three kernels' inputs."""
        def run(params, st, grid, batch, cfg, prob=False):
            kind = "probe_chunk" if prob else "eval_chunk"
            before = {n: self.kernels[n].launches
                      for n in self.render_kernels}
            record = (kind not in self.captured
                      and self._chunk == self._chunks // 2)
            with (recording_kernels() if record
                  else contextlib.nullcontext()) as seen:
                out = real(params, st, grid, batch, cfg, prob=prob)
            if record:
                self.captured[kind] = all_recorded(seen, f"a {kind}",
                                                   self.render_kernels)
            self._chunk += 1
            for n in self.render_kernels:
                if self.kernels[n].launches != before[n] + 1:
                    fail(f"a {'probe' if prob else 'eval'} chunk launched {n} "
                         f"{self.kernels[n].launches - before[n]} times, not "
                         f"once")
            return out
        return run

    def apply_grow(self, real):
        """A grown point sits at a hit ray's max-opacity sample, which has a
        neighbor within the KNN radius: each lies within that radius of the
        cloud before the grow, and the first grow's (before any split, from
        points on the sphere) within it of the sphere's radius."""
        def run(state, st, cand, cfg):
            torch = self.torch
            n = int(st.num_active)
            old = state.params["points"].xyz[:n]
            state, st, added = self._timed("grow", real, state, st, cand, cfg)
            self.log.append(("grow", (n, added)))
            if added:
                new = state.params["points"].xyz[n:n + added]
                near = float(torch.cdist(
                    new, old, compute_mode="donot_use_mm_for_euclid_dist")
                    .amin(1).max())
                shell = float((torch.linalg.norm(new, dim=-1) - 0.5).abs()
                              .max())
                r = cfg.query.radius_limit
                first = not any(e == "grow_shell" for e, _d in self.log)
                self.log.append(("grow_shell", (near, shell)))
                log(f"grow: {added} points, the farthest {near:.5f} from the "
                    f"cloud before it and {shell:.5f} from the sphere's "
                    f"radius (KNN radius {r})")
                if not near <= r * (1 + 1e-5):
                    fail(f"a grown point lies {near:.5f} from the cloud, "
                         f"beyond the KNN radius {r}")
                if first and not shell <= r * (1 + 1e-5):
                    fail(f"a point of the first grow lies {shell:.5f} from the "
                         f"sphere, beyond the KNN radius {r}")
            return state, st, added
        return run

    def split_high_grad(self, real):
        def run(state, st, cfg):
            n = int(st.num_active)
            state, st, added = self._timed("split", real, state, st, cfg)
            self.log.append(("split", (n, added)))
            return state, st, added
        return run

    def refresh_grid(self, real):
        def run(pc, st, cfg, max_d=None):
            grid, used = self._timed("grid_refresh", real, pc, st, cfg,
                                     max_d=max_d)
            self.log.append(("grid", (max_d, used, int(st.num_active))))
            return grid, used
        return run

    def train_step(self, real):
        def run(state, st, grid, batch, cfg):
            before = {n: self.kernels[n].launches
                      for n in self.train_kernels}
            record = len(self.times["train_step"]) + 1 == self.record_step
            with (recording_decode() if record
                  else contextlib.nullcontext()) as seen:
                state, items = self._timed("train_step", real, state, st,
                                           grid, batch, cfg)
            if record:
                self.step_inputs = seen
            for n in self.train_kernels:
                if self.kernels[n].launches != before[n] + 1:
                    fail(f"a maintenance-path train step launched {n} "
                         f"{self.kernels[n].launches - before[n]} times")
            self.losses.append(items["loss_total"])
            return state, items
        return run

    def save_checkpoint(self, real):
        def run(root, state, meta=None):
            path = self._timed("checkpoint_save", real, root, state, meta)
            self.saved = (path, state, self.torch.clone(state.key.get_state()))
            self.log.append(("save", path))
            return path
        return run

    def load_checkpoint(self, real):
        def run(path, template):
            state, meta = self._timed("checkpoint_load", real, path, template)
            self.log.append(("load", path))
            if self.saved is None or self.saved[0] != path:
                fail(f"resumed from {path}, not the last checkpoint written")
            same_state(state, self.saved[1], self.saved[2])
            return state, meta
        return run


def same_state(a, b, key_state):
    """Fail unless two TrainStates are equal bit for bit: parameters,
    moments and counts, hit counters, step, and the generator state."""
    import torch
    from pointnerf_tpu_torch.train.optim import tree_leaves
    la = tree_leaves([a.params, a.opt_state, a.step, a.hits])
    lb = tree_leaves([b.params, b.opt_state, b.step, b.hits])
    if len(la) != len(lb):
        fail("the loaded state has another structure than the saved one")
    bad = [i for i, (x, y) in enumerate(zip(la, lb))
           if x.shape != y.shape or x.dtype != y.dtype
           or not torch.equal(x.reshape(-1).view(torch.uint8),
                              y.reshape(-1).view(torch.uint8))]
    if bad or not torch.equal(a.key.get_state(), key_state):
        fail(f"the loaded state differs from the saved one (leaves {bad}, "
             f"generator {torch.equal(a.key.get_state(), key_state)})")
    log(f"checkpoint: the loaded state equals the saved one bit for bit "
        f"({len(la)} tensors, step {int(a.step)}, the generator state)")


def check_maintenance_log(rec: MaintRecorder):
    """Every point-set change is followed by a grid rebuild with the table
    size the previous build settled on and the new point count; each event
    kind fired."""
    last_max_d, pending = None, None
    kinds = {}
    for ev, detail in rec.log:
        kinds[ev] = kinds.get(ev, 0) + 1
        if ev == "grid":
            max_d, used, n = detail
            if last_max_d is not None and max_d != last_max_d:
                fail(f"a grid rebuild took max_d={max_d}, not the carried "
                     f"{last_max_d}")
            if pending is not None and n != pending:
                fail(f"the grid was rebuilt at {n} points, not {pending}")
            last_max_d, pending = used, None
        elif ev == "load":
            last_max_d = None       # a new run builds from the config
        elif ev in ("prune", "grow", "split"):
            if pending is not None:
                fail(f"a {ev} came before the grid was rebuilt")
            n, after = detail
            if ev == "prune" or after:
                pending = after if ev == "prune" else n + after
    if pending is not None:
        fail("the last point-set change was not followed by a grid rebuild")
    grows = [d for e, d in rec.log if e == "grow"]
    splits = [d for e, d in rec.log if e == "split"]
    if not grows or not grows[0][1] > 0:
        fail(f"the first probe grew no point: {grows}")
    if not any(a > 0 for _n, a in splits):
        fail(f"no split added a point: {splits}")
    for ev in ("prune", "probe", "grow", "split", "save", "load"):
        if not kinds.get(ev):
            fail(f"the maintenance path never ran a {ev}")
    if not rec.times["eval_frame"]:
        fail("the maintenance path never evaluated a frame")
    return kinds


def window_parity(cfg, rec: MaintRecorder):
    """A 16 x 16 window of the first probe frame around a hole's edge,
    rendered with the probe outputs from the state that probe saw, on the
    card and on the CPU (plain versions):
    neighbor ids and masks equal, the argmax sample equal on every hit ray
    whose CPU top-two opacity gap exceeds TIE_MARGIN of max|CPU| (a closer
    pair may swap; such rays are counted, and fail the run when more than
    MAX_TIE_SHARE of the hit rays), the decoded opacities (per sample and
    the peak) on their mean error, and the other probe outputs on their
    largest, each beside its control."""
    import numpy as np
    import torch
    from pointnerf_tpu_torch.models.renderer import RayBatch
    from pointnerf_tpu_torch.ops.grid import build_grid
    from pointnerf_tpu_torch.train.optim import tree_map
    from pointnerf_tpu_torch.train.step import eval_step
    item = rec.probe_item
    W, H = MAINT_WH
    hit = rec.maps["ray_mask"][..., 0]
    gt = np.zeros((H, W, 3), np.float32)
    pix = np.asarray(item["pixel_idx"], np.int64)
    gt[pix[:, 1], pix[:, 0]] = item["gt_image"]
    bg = np.asarray(cfg.render.bg_color, np.float32)
    hole = ~hit & (np.linalg.norm(gt - bg, axis=-1) > 0.002)
    from pointnerf_tpu_torch.train.grow import _dilate3
    ys, xs = np.nonzero(hole & _dilate3(hit))
    if ys.size == 0:
        fail("the first probe frame has no hole next to a hit ray")
    params, st, grid = rec.first_probe
    y0 = int(np.clip(ys[0] - 8, 0, H - 16))
    x0 = int(np.clip(xs[0] - 8, 0, W - 16))
    sel = ((pix[:, 1] >= y0) & (pix[:, 1] < y0 + 16)
           & (pix[:, 0] >= x0) & (pix[:, 0] < x0 + 16))
    cpu = torch.device("cpu")

    def batch(dev):
        t = lambda a, dt=torch.float32: torch.tensor(  # noqa: E731
            np.asarray(a), dtype=dt, device=dev)
        return RayBatch(campos=t(item["campos"]),
                        camrotc2w=t(item["camrotc2w"]),
                        raydir=t(item["raydir"][sel]),
                        pixel_idx=t(pix[sel], torch.int32),
                        near=t(cfg.render.near_plane),
                        far=t(cfg.render.far_plane))
    params_c = tree_map(lambda x: x.to(cpu), params)
    st_c = type(st)(*[x.to(cpu) for x in st])
    q = dataclasses.replace(cfg.query, max_d=grid.nbr_pid.shape[0])
    grid_c = build_grid(params_c["points"].xyz, st_c.num_active, q)
    o_card = eval_step(params, st, grid, batch(st.num_active.device), cfg,
                       prob=True)
    o_cpu = eval_step(params_c, st_c, grid_c, batch(cpu), cfg, prob=True)
    cfg32 = cfg.replace(train=dataclasses.replace(cfg.train,
                                                  compute_dtype="f32"))
    o_ctl = eval_step(params_c, st_c, grid_c, batch(cpu), cfg32, prob=True)
    for f in ("ray_mask", "ray_valid", "neighbor_pidx"):
        if not torch.equal(getattr(o_card, f).cpu(), getattr(o_cpu, f)):
            fail(f"probe window: {f} differs between the card and the CPU")
    rmask = o_cpu.ray_mask
    if not (bool(rmask.any()) and not bool(rmask.all())):
        fail("the probe window holds no hole edge (all rays hit or miss)")
    op_k, op_c = o_card.coarse_point_opacity.cpu(), o_cpu.coarse_point_opacity
    op_scale = float(op_c.abs().max())
    # two samples whose CPU opacities lie within the margin may swap
    margin = TIE_MARGIN * op_scale
    top2 = op_c.topk(2, dim=-1).values
    clear = rmask & (top2[:, 0] - top2[:, 1] > margin)
    n_hit, n_tie = int(rmask.sum()), int((rmask & ~clear).sum())
    am_k, am_c = op_k.argmax(-1), op_c.argmax(-1)
    log(f"probe window {x0}..{x0 + 15} x {y0}..{y0 + 15}: ray_mask, ray_valid "
        f"and neighbor ids equal; {n_hit} of 256 rays hit; the argmax sample "
        f"compared on {int(clear.sum())} rays, {n_tie} near ties (top-two "
        f"gap within {margin:.3e}, {int((am_k != am_c)[rmask].sum())} of them "
        f"swapped)")
    if n_tie > n_hit * MAX_TIE_SHARE:
        fail(f"probe window: {n_tie} of {n_hit} hit rays are near ties, more "
             f"than {MAX_TIE_SHARE} of them")
    if not torch.equal(am_k[clear], am_c[clear]):
        fail("probe window: the argmax sample differs between the card and "
             "the CPU on a ray without a near tie")
    for f, which, rays in (("coarse_point_opacity", "hit", rmask),
                           ("ray_max_shading_opacity", "compared", clear)):
        a, b = getattr(o_card, f).cpu()[rays], getattr(o_cpu, f)[rays]
        log(f"probe window {f}: largest |err| / max|CPU| "
            f"{float((a - b).abs().max()) / float(b.abs().max()):.3e} "
            f"(printed only)")
        hold_bf16(f"card vs CPU probe window, {f} of the {which} rays, mean "
                  f"|err| / mean |CPU|", mean_rel(a, b),
                  mean_rel(getattr(o_ctl, f)[rays], b), OPACITY_BF16_TOL)
    for f, bar in PROBE_TOL.items():
        b = getattr(o_cpu, f)
        a = getattr(o_card, f).cpu()[clear]
        c = b.roll(1, 0)[clear]
        b = b[clear]
        s = float(b.abs().max())
        if not s > 0:
            fail(f"probe window: {f} is all zero on the compared rays")
        err, ctl = (float((x - b).abs().max()) / s for x in (a, c))
        hold_bf16(f"card vs CPU probe window, {f}, max |err| / max |CPU|",
                  err, ctl, bar, "the next ray's value")


def maintenance_path(cfg, kernels, device="cuda"):
    """train_scene at bench width with every maintenance event, then a
    resume from its last checkpoint for a few more steps. Returns the
    recorder, the launch counts and routes of both runs, the seconds per
    event and the train rays/s of the steps."""
    import tempfile
    import numpy as np
    import torch
    from pointnerf_tpu_torch.train import driver as td
    mcfg = maintenance_config(cfg)
    pts, conf, train_item, probe, test = maintenance_scene()
    rec = MaintRecorder(mcfg, kernels)
    log(f"maintenance scene: {pts[0].shape[0]} of {N_POINTS} points left "
        f"after the silhouette band ({SILHOUETTE_BAND_DEG} deg) of view 0 is "
        f"cut, {int((conf < mcfg.train.prune_thresh).sum())} below "
        f"prune_thresh")
    reset_counts(kernels)
    rec.install()
    try:
        build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build")
        os.makedirs(build, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build) as run_dir:
            t0 = time.perf_counter()
            _state, _st, hist = td.train_scene(
                mcfg, pts, train_item, test, probe, MAINT_WH, run_dir=run_dir,
                conf=conf, device=device)
            t1 = time.perf_counter()
            state2, _st2, hist2 = td.train_scene(
                mcfg, pts, train_item, test, probe, MAINT_WH, run_dir=run_dir,
                max_steps=MAINT_RESUME_TO, resume=True, conf=conf,
                device=device)
            t2 = time.perf_counter()
    finally:
        rec.restore()
    counts = {n: k.launches for n, k in kernels.items()}
    routes = kernel_routes(kernels, "maintenance")
    if int(state2.step) != MAINT_RESUME_TO:
        fail(f"the resumed run ended at step {int(state2.step)}")
    kinds = check_maintenance_log(rec)
    losses = torch.stack(rec.losses).cpu()
    psnrs = [m["psnr"] for m in hist["eval"] + hist2["eval"]]
    if not bool(torch.isfinite(losses).all()) or not psnrs \
            or not all(np.isfinite(psnrs)):
        fail(f"maintenance path: losses or PSNR not finite: "
             f"{losses.tolist()}, {psnrs}")
    n_steps = len(rec.times["train_step"])
    if n_steps != MAINT_RESUME_TO:
        fail(f"the maintenance path took {n_steps} train steps")
    rate = n_steps * N_RAYS / sum(rec.times["train_step"])
    log(f"maintenance events: {[e for e in rec.log if e[0] != 'grid']}")
    log(f"maintenance grid rebuilds (max_d passed, used, points): "
        f"{[d for e, d in rec.log if e == 'grid']}")
    log(f"maintenance path: {MAINT_STEPS} steps then a resume to "
        f"{MAINT_RESUME_TO}: {t1 - t0:.2f} s + {t2 - t1:.2f} s (host clock); "
        f"losses finite, eval PSNR {psnrs}, event counts {kinds}")
    log(f"maintenance path: {n_steps} train steps of {N_RAYS} rays at "
        f"{rate:.1f} train rays/s (the steps alone, each synchronized)")
    secs = {k: (sum(v) / len(v) if v else None, len(v))
            for k, v in rec.times.items()}
    log("maintenance seconds per event (mean, count): " + ", ".join(
        f"{k} {m:.4f} x{c}" for k, (m, c) in secs.items() if m is not None))
    log(f"maintenance launches {counts}, routes {routes}")
    return rec, counts, routes, secs, rate


# ---- the dataset path: scene_config() as train_dataset_scene builds it ----
DS_WH = (800, 800)
DS_TRAIN_VIEWS = 6          # NeRF-Synthetic has 100 (cut)
DS_TEST_VIEWS = 1           # and 200 (cut)
DS_POINTS = 200_000
DS_STEPS = 16
DS_CAMERA_DIST = 4.0        # NeRF-Synthetic's camera distance
DS_CAMERA_ANGLE_X = 0.6911112070083618
DS_SCAN = "cluster"
VOX_POINTS = 2_500_000      # above train_dataset_scene's 2M downsample line
QUERY_RAYS = 512


def blender_pose(azim_deg: float, elev_deg: float, dist: float):
    """Camera-to-world [4, 4] in the blender convention (x right, y up, z
    back), at `dist` from the origin and looking at it."""
    import numpy as np
    a, e = np.radians(azim_deg), np.radians(elev_deg)
    pos = dist * np.array([np.cos(e) * np.sin(a), np.sin(e),
                           np.cos(e) * np.cos(a)])
    back = pos / np.linalg.norm(pos)
    right = np.cross([0.0, 1.0, 0.0], back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, up, back, pos
    return pose


def write_nerf_synth_scene(root: str):
    """The procedural `cluster` scene in the NeRF-Synthetic layout under
    `root`: 800 x 800 RGB PNGs of its analytic ground truth (the port's
    write_png), transforms_{train,test}.json with blender poses at distance
    DS_CAMERA_DIST, and points.ply of DS_POINTS surface samples."""
    import numpy as np
    from pointnerf_tpu_torch.camera import BLENDER2OPENCV, get_dtu_raydir
    from pointnerf_tpu_torch.data.ply import save_ply
    from pointnerf_tpu_torch.data.procedural import (SCENES, gt_render,
                                                      sample_cloud)
    from pointnerf_tpu_torch.utils.visualizer import to8b, write_png
    prims = SCENES[DS_SCAN]()
    W, H = DS_WH
    focal = 0.5 * W / np.tan(0.5 * DS_CAMERA_ANGLE_X)
    K = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1]],
                 np.float32)
    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    pix = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    views = {"train": [(60.0 * i, 25.0 if i % 2 else -10.0)
                       for i in range(DS_TRAIN_VIEWS)],
             "test": [(30.0 + 90.0 * i, 15.0) for i in range(DS_TEST_VIEWS)]}
    for split, angles in views.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i, (az, el) in enumerate(angles):
            pose = blender_pose(az, el, DS_CAMERA_DIST)
            cv = (pose.astype(np.float32) @ BLENDER2OPENCV)
            rd = get_dtu_raydir(pix, K, cv[:3, :3]).astype(np.float32)
            img = gt_render(prims, cv[:3, 3].astype(np.float32), rd)
            write_png(os.path.join(root, split, f"r_{i}.png"),
                      to8b(img.reshape(H, W, 3)))
            frames.append({"file_path": f"{split}/r_{i}",
                           "transform_matrix": pose.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": DS_CAMERA_ANGLE_X,
                       "frames": frames}, f)
    xyz, color, _normals = sample_cloud(prims, DS_POINTS, seed=0)
    save_ply(os.path.join(root, "points.ply"), xyz, color)


def dataset_config(xyz):
    """scene_config() of the cloud as train_dataset_scene builds it (K=8,
    SR=80, D=400, H=256, f32, dense decode, bucket + shell-layered KNN, the
    fused flags off), with only the schedule cut to DS_STEPS steps: one
    prune (step 10), one eval of the test view and one checkpoint (step
    16)."""
    from pointnerf_tpu_torch.config import scene_config
    cfg = scene_config(xyz, near=2.0, far=6.0)
    return cfg.replace(train=dataclasses.replace(
        cfg.train, maximum_step=DS_STEPS, prune_iter=10, test_freq=DS_STEPS,
        save_iter_freq=DS_STEPS, print_freq=4))


def dataset_path(kernels, data_root: str, device="cuda"):
    """train_dataset_scene for DS_STEPS steps on the nerf_synth scene, then
    test_dataset_scene from its checkpoint. Every train step launches K3
    and K4 once on the CUDA-core (f32) route, every eval chunk K3 and K2
    once, K1 never (the bucket branch is torch code, as it is XLA code in
    JAX); the two PSNRs of the test view agree. Returns the recorder, the
    launch counts and routes, the seconds per event and the PSNR."""
    import numpy as np
    import torch
    from pointnerf_tpu_torch.data.ply import load_ply
    from pointnerf_tpu_torch.train import driver as td
    xyz = load_ply(os.path.join(data_root, DS_SCAN, "points.ply"))["xyz"]
    cfg = dataset_config(xyz)
    q = cfg.query
    log(f"dataset config: vsize {q.vsize[0]:.6f}, ranges "
        f"{tuple(round(r, 4) for r in q.ranges)}, K={q.K} SR={q.SR} "
        f"D={q.z_depth_dim} P={q.P} max_o={q.max_o}, shell_layered "
        f"{q.shell_layered}, prebuild_neighbors {q.prebuild_neighbors}, "
        f"decode_capacity {q.decode_capacity}, compute "
        f"{cfg.train.compute_dtype}, fused_decode {cfg.agg.fused_decode}, "
        f"fused_march {cfg.render.fused_march}")
    rec = MaintRecorder(cfg, kernels, ("fused_decode", "fused_decode_bwd"),
                        ("fused_decode", "fused_march"),
                        record_step=DS_STEPS // 2)
    reset_counts(kernels)
    rec.install()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    try:
        with tempfile_dir(build) as run_dir:
            t0 = time.perf_counter()
            state, _st, hist = td.train_dataset_scene(
                "nerf_synth360_ft", data_root, DS_SCAN, run_dir,
                max_steps=DS_STEPS, cfg=cfg, resume=False, device=device)
            t1 = time.perf_counter()
            m = td.test_dataset_scene("nerf_synth360_ft", data_root, DS_SCAN,
                                      run_dir, cfg=cfg, save_images=False,
                                      device=device)
            t2 = time.perf_counter()
    finally:
        rec.restore()
    counts = {n: k.launches for n, k in kernels.items()}
    routes = {n: dict(kernels[n].launches_by_route)
              for n in ("fused_decode", "fused_decode_bwd")}
    n_steps = len(rec.times["train_step"])
    n_chunks = -(-DS_WH[0] * DS_WH[1] // 9216)
    frames = len(rec.times["eval_frame"])
    if int(state.step) != DS_STEPS or n_steps != DS_STEPS:
        fail(f"the dataset path took {n_steps} steps")
    if frames != 2:
        fail(f"the dataset path rendered {frames} eval frames, not 2")
    want = {"knn_select": 0, "fused_decode": DS_STEPS + frames * n_chunks,
            "fused_decode_bwd": DS_STEPS, "fused_march": frames * n_chunks}
    if counts != want:
        fail(f"dataset path launches {counts}, expected {want}")
    for n in routes:
        if routes[n]["tensor_core"]:
            fail(f"the f32 dataset path launched {n} on the tensor cores")
    kinds = [e for e, _d in rec.log if e not in ("grid",)]
    if kinds.count("prune") != 1 or "save" not in kinds \
            or "load" not in kinds:
        fail(f"dataset path events {kinds}: expected one prune, a "
             f"checkpoint and its load")
    losses = torch.stack(rec.losses).cpu()
    p_train = hist["eval"][-1]["psnr"] if hist["eval"] else float("nan")
    if not bool(torch.isfinite(losses).all()) \
            or not np.isfinite([p_train, m["psnr"]]).all():
        fail(f"dataset path: losses or PSNR not finite: {losses.tolist()}, "
             f"{p_train}, {m['psnr']}")
    if not abs(p_train - m["psnr"]) <= 1e-2:
        fail(f"test_dataset_scene PSNR {m['psnr']} differs from the "
             f"training run's eval {p_train} by more than 0.01 dB")
    secs = {k: (sum(v) / len(v) if v else None, len(v))
            for k, v in rec.times.items()}
    log(f"dataset path: losses {[round(float(v), 6) for v in losses]}")
    log(f"dataset path: {DS_STEPS} steps of {N_RAYS} rays, a prune "
        f"({[d for e, d in rec.log if e == 'prune']}), an eval and a "
        f"checkpoint, then test_dataset_scene: {t1 - t0:.2f} s + "
        f"{t2 - t1:.2f} s (host clock); eval PSNR {p_train:.4f} dB, "
        f"test_dataset_scene {m['psnr']:.4f} dB (SSIM {m['ssim']:.4f}); "
        f"launches {counts}, routes {routes}")
    log("dataset seconds per event (mean, count): " + ", ".join(
        f"{k} {v:.4f} x{c}" for k, (v, c) in secs.items() if v is not None))
    return rec, counts, routes, secs, m["psnr"]


@contextlib.contextmanager
def tempfile_dir(parent: str):
    import tempfile
    os.makedirs(parent, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=parent) as d:
        yield d


def live_counts(w, K: int, g_fagg=None, g_alpha=None):
    """The f32 kernels' live-group list (the list pass alone, K3's rule or,
    given the upstream gradients, K4's) held against live_groups_plain bit
    for bit; returns (rows with weight, live groups x K, 64-row tiles with a
    weighted row): the rows a kernel must compute, the rows the f32 kernels
    compute, and the rows a test per tile would compute."""
    import torch
    from pointnerf_tpu_torch.ops.fused_decode import (F32_ROWS, live_groups,
                                                      live_groups_plain)
    got = live_groups(w, K, g_fagg, g_alpha)
    want = live_groups_plain(w, K, g_fagg, g_alpha)
    if not torch.equal(got, want):
        fail(f"the live-group list ({got.numel()} groups) differs from its "
             f"plain version ({want.numel()})")
    row = (w != 0).view(-1)
    pad = (-row.numel()) % F32_ROWS
    tiles = int(torch.nn.functional.pad(row, (0, pad)).view(-1, F32_ROWS)
                .any(1).sum())
    return int(row.sum()), got.numel() * K, tiles * F32_ROWS


# readings of the first f32 kernels (no live list) on the dataset path, on
# an H100 80GB HBM3 at 700 W (PERF.md §6), printed beside this run's
FIRST_F32_MS = {"K3 f32, train step": 94.1594, "K3 f32, eval chunk": 242.2127,
                "K4 f32, train step": 295.6045}


def check_f32_decode(fwd_cases, bwd_args):
    """K3 f32 on each (label, args) of `fwd_cases` and K4 f32 on `bwd_args`
    against their plain versions (K3 within K3_F32_TOL of max|plain|, K4
    each gradient within K4_F32_TOL of its max|plain|, and the same bits in
    two K4 calls), with times, the plain versions' times and the bounds, and
    the live rows, groups and tiles of each input. Returns {label: numbers}
    for K3 and the numbers of K4."""
    import torch
    from pointnerf_tpu_torch.ops.fused_decode import (flops, fused_decode,
                                                      fused_decode_bwd,
                                                      fused_decode_bwd_plain,
                                                      fused_decode_plain,
                                                      param_count)

    def live_log(what, M, counts):
        rows, grouped, tiled = counts
        log(f"{what}, M={M}: {rows} rows carry weight; live groups x K = "
            f"{grouped} rows decoded ({grouped / M:.4%}); 64-row tiles with "
            f"a weighted row = {tiled} rows ({tiled / M:.4%})")

    k3 = {}
    for label, args in fwd_cases:
        feat, dists, extras, w, params, spec = args
        if spec.bf16:
            fail(f"the recorded {label} decode is not on the f32 route")
        M = feat.shape[0]
        counts = live_counts(w, spec.K)
        live_log(f"K3 f32 live list, {label}", M, counts)
        with torch.no_grad():
            out = fused_decode(feat, dists, extras, w, params, spec)
            plain = fused_decode_plain(feat, dists, extras, w, params, spec)
            torch.cuda.synchronize()
            scale = max(float(t.abs().max()) for t in plain)
            err = max(float((a - b).abs().max()) for a, b in zip(out, plain))
            del out, plain
            ms = cuda_ms(lambda: fused_decode(feat, dists, extras, w, params,
                                              spec), iters=5, warmup=1)
            plain_ms = cuda_ms(lambda: fused_decode_plain(
                feat, dists, extras, w, params, spec), iters=2, warmup=1)
        rows = int((w != 0).sum())
        wbytes = sum(p.numel() * 4 for n in ("block1", "block3", "alpha")
                     for layer in params[n] for p in layer.values())
        nbytes = rows * (spec.Fi + spec.Dd + spec.E + 1) * 4 + wbytes \
            + (M // spec.K) * (spec.H + 1) * 4
        b, by = bound_ms(nbytes, flops(rows, spec), PEAK_F32)
        log(f"K3 f32 (cuda_core kernel), {label}, M={M} H={spec.H}: max abs "
            f"err {err:.3e}, scale {scale:.3e} (tolerance {K3_F32_TOL} x "
            f"scale); time {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b:.4f} ms ({by}: {rows} of {M} rows carry weight), "
            f"{b / ms:.2%} of the bound; "
            f"{flops(counts[1], spec) / ms / 1e9:.2f} TFLOP/s on the "
            f"{counts[1]} rows it computes")
        if not err <= K3_F32_TOL * scale:
            fail(f"K3 (f32) disagrees with its plain version on the {label}")
        k3[label] = {"M": M, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     "library_ms": None, "live_rows": counts[0],
                     "live_group_rows": counts[1],
                     "live_tile_rows": counts[2]}

    feat, dists, extras, w, params, spec, g_fagg, g_alpha = bwd_args
    M = feat.shape[0]
    counts = live_counts(w, spec.K, g_fagg, g_alpha)
    live_log("K4 f32 live list, train step", M, counts)
    with torch.no_grad():
        names, out = decode_grad_leaves(fused_decode_bwd(
            feat, dists, extras, w, params, spec, g_fagg, g_alpha))
        _, plain = decode_grad_leaves(fused_decode_bwd_plain(
            feat, dists, extras, w, params, spec, g_fagg, g_alpha))
        _, again = decode_grad_leaves(fused_decode_bwd(
            feat, dists, extras, w, params, spec, g_fagg, g_alpha))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(out, again))
        rel, abs_err = [], 0.0
        for a, p in zip(out, plain):
            s = float(p.abs().max())
            e = float((a - p).abs().max())
            abs_err = max(abs_err, e)
            rel.append(e / s if s > 0 else (0.0 if e == 0 else float("inf")))
        del out, plain, again
        worst = max(range(len(rel)), key=rel.__getitem__)
        ms = cuda_ms(lambda: fused_decode_bwd(feat, dists, extras, w, params,
                                              spec, g_fagg, g_alpha),
                     iters=5, warmup=1)
        plain_ms = cuda_ms(lambda: fused_decode_bwd_plain(
            feat, dists, extras, w, params, spec, g_fagg, g_alpha),
            iters=2, warmup=1)
    rows = int((w != 0).sum())
    wbytes = sum(p.numel() * 4 for n in ("block1", "block3", "alpha")
                 for layer in params[n] for p in layer.values())
    width = spec.Fi + spec.Dd + spec.E + 1
    nbytes = (rows * width * 4 + M * 4 + wbytes
              + (M // spec.K) * (spec.H + 1) * 4
              + M * width * 4 + param_count(spec) * 4)
    b, by = bound_ms(nbytes, 3 * flops(rows, spec), PEAK_F32)
    log(f"K4 f32 (cuda_core kernel), train step, M={M} H={spec.H}: max abs "
        f"err {abs_err:.3e}, worst relative {rel[worst]:.3e} ({names[worst]}, "
        f"tolerance {K4_F32_TOL}); time {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b:.4f} ms ({by}: {rows} of {M} rows carry weight), "
        f"{b / ms:.2%} of the bound; "
        f"{3 * flops(counts[1], spec) / ms / 1e9:.2f} TFLOP/s on the "
        f"{counts[1]} rows it computes")
    log(f"K4 f32: two calls on the same inputs give the same bits in every "
        f"gradient: {same}")
    if not rel[worst] <= K4_F32_TOL:
        fail("K4 (f32) disagrees with its plain version on the train step")
    if not same:
        fail("K4 (f32) is not deterministic run to run")
    k4 = {"M": M, "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": b, "bound_by": by, "library_ms": None,
          "live_rows": counts[0], "live_group_rows": counts[1],
          "live_tile_rows": counts[2]}
    return k3, k4


def query_branches(data_root: str, cfg_ds, device="cuda"):
    """QUERY_RAYS rays of the dataset scene's test view through every ray
    generator (un-jittered, and jittered from one shared draw) and every KNN
    branch — bucket rows or prebuilt tables; K nearest, shell-layered, or
    the NN=0 random subset — on the card and on the CPU: slot masks and
    neighbor ids equal."""
    import numpy as np
    import torch
    from pointnerf_tpu_torch.config import DataConfig, generator_kwargs
    from pointnerf_tpu_torch.data import find_dataset_class_by_name
    from pointnerf_tpu_torch.data.ply import load_ply
    from pointnerf_tpu_torch.ops.grid import build_grid
    from pointnerf_tpu_torch.ops.query import RAY_GENERATORS, query_points
    cpu, dev = torch.device("cpu"), torch.device(device)
    ds = find_dataset_class_by_name("nerf_synth360_ft")(
        DataConfig(data_root=data_root, scan=DS_SCAN), split="test")
    item = ds.get_item(0)
    rng = np.random.RandomState(3)
    sel = rng.choice(len(item["raydir"]), QUERY_RAYS, replace=False)
    xyz = load_ply(os.path.join(data_root, DS_SCAN, "points.ply"))["xyz"]
    n = xyz.shape[0]
    t = {d: (torch.tensor(xyz, device=d), torch.tensor(item["campos"],
                                                         device=d),
             torch.tensor(item["raydir"][sel], device=d)) for d in (cpu, dev)}
    branches = {
        "bucket, shell-layered": dict(),
        "bucket": dict(shell_layered=False),
        "bucket, NN=0": dict(NN=0),
        "tables, shell-layered": dict(prebuild_neighbors=True),
        "tables, NN=0": dict(prebuild_neighbors=True, NN=0),
        "tables (K1)": dict(prebuild_neighbors=True, shell_layered=False)}
    cfg_ds = cfg_ds.replace(render=dataclasses.replace(cfg_ds.render,
                                                        ray_middle=4.0))
    D = cfg_ds.query.z_depth_dim
    n_slots = n_hits = 0
    t0 = time.perf_counter()
    for bname, kw in branches.items():
        q = dataclasses.replace(cfg_ds.query, **kw)
        if q.prebuild_neighbors:
            q = dataclasses.replace(q, max_d=262144)
        grid_d = build_grid(t[dev][0], torch.tensor(n, device=dev), q)
        need = int(grid_d.num_dil)
        if q.prebuild_neighbors and need > q.max_d:
            q = dataclasses.replace(q, max_d=-(-int(need * 1.25) // 4096)
                                    * 4096)
            grid_d = build_grid(t[dev][0], torch.tensor(n, device=dev), q)
        grid_c = build_grid(t[cpu][0], torch.tensor(n), q)
        for name in RAY_GENERATORS:
            cg = cfg_ds.replace(render=dataclasses.replace(
                cfg_ds.render, which_ray_generation=name))
            jitters = [0.0] + ([0.3] if bname == "bucket, shell-layered"
                               else [])
            for jit in jitters:
                u = None
                if jit:
                    cols = {"near_far_disparity_linear": D + 1,
                            "near_middle_far": int(D * 0.6) + int(D * 0.4)
                            + 2}.get(name, D)
                    u = torch.rand((QUERY_RAYS, cols),
                                   generator=torch.Generator().manual_seed(5))
                outs = {}
                for d, g in ((dev, grid_d), (cpu, grid_c)):
                    x, c, r = t[d]
                    outs[d.type] = query_points(
                        x, g, c, r, 2.0, 6.0, q, jitter=jit,
                        u=None if u is None else u.to(d), gen_name=name,
                        gen_kwargs=generator_kwargs(cg))
                a, b = outs[dev.type], outs["cpu"]
                for f in ("sample_mask", "ray_mask", "sample_pidx"):
                    if not torch.equal(getattr(a, f).cpu(), getattr(b, f)):
                        fail(f"query {bname}, {name}, jitter {jit}: {f} "
                             f"differs between the card and the CPU")
                n_slots += int(b.sample_mask.sum())
                n_hits += int(b.ray_mask.sum())
    log(f"query branches, card vs CPU: {len(branches)} KNN branches x "
        f"{len(RAY_GENERATORS)} generators (+ the jittered generators on the "
        f"default branch) on {QUERY_RAYS} rays of the test view: slot masks, "
        f"ray masks and neighbor ids equal ({n_slots} shading slots, "
        f"{n_hits} rays with a neighbor over all runs), "
        f"{time.perf_counter() - t0:.2f} s")


def voxel_parity():
    """construct_vox_points_closest on the card and on the CPU over a
    VOX_POINTS-point cluster cloud: the same kept ids and centroids."""
    import numpy as np
    from pointnerf_tpu_torch.data.procedural import SCENES, sample_cloud
    from pointnerf_tpu_torch.ops.voxel import construct_vox_points_closest
    xyz, _c, _n = sample_cloud(SCENES[DS_SCAN](), VOX_POINTS, seed=1)
    t0 = time.perf_counter()
    ic, cc = construct_vox_points_closest(xyz, 320, device="cuda")
    t1 = time.perf_counter()
    ih, ch = construct_vox_points_closest(xyz, 320, device="cpu")
    t2 = time.perf_counter()
    if not (np.array_equal(ic, ih) and np.array_equal(cc, ch)):
        fail(f"construct_vox_points_closest: {int((ic != ih).sum())} ids "
             f"differ between the card and the CPU")
    log(f"voxel downsample of {VOX_POINTS} points at 320^3: {len(ic)} kept, "
        f"ids and centroids equal on the card and the CPU; card "
        f"{t1 - t0:.3f} s, CPU {t2 - t1:.3f} s")


# ---- the flags-off path: the recorded quality configuration ----
QUALITY_OPT = "runs/quality_cluster_full_r5/opt.json"
QUALITY_POINTS = 200_000
FLAGS_OFF_WARMUP, FLAGS_OFF_STEPS, FLAGS_OFF_REQUESTS = 3, 10, 2


def quality_config():
    """The recorded quality configuration of the JAX package: prebuilt
    tables, no shell cut, compacted decode at capacity 0.4, bf16, and both
    fused flags off."""
    from pointnerf_tpu_torch.config import PointNeRFConfig
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           QUALITY_OPT)) as f:
        return PointNeRFConfig.from_json(f.read())


def flags_off_path(kernels, device="cuda"):
    """The quality configuration on the QUALITY_POINTS-point cluster cloud
    with random weights: a 512-ray request on the card against the CPU run
    with the flags set (held to phase 5's bars); FLAGS_OFF_WARMUP +
    FLAGS_OFF_STEPS train steps of 3,600 rays on one batch (K1 on its run
    path, K3 and K4 on the tensor cores once each per step) and
    FLAGS_OFF_REQUESTS serving requests (K1, K3 and K2 once each), although
    both fused flags are off; then the same request from the trained state,
    held to COLOR_TRAINED_BF16_TOL. Each kernel is then held against its
    plain version on the inputs the path gave it: K3 and K4 on a recorded
    train step's, K1, K3 and K2 on a recorded request's. Returns the
    launches, the routes and {"flags_off_step"|"flags_off_request":
    {kernel: numbers}}."""
    import torch
    from pointnerf_tpu_torch.data.procedural import (SCENES, sample_cloud,
                                                      sphere_cameras,
                                                      view_item)
    from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
    from pointnerf_tpu_torch.models.points import make_point_cloud
    from pointnerf_tpu_torch.models.renderer import ray_batch_from_numpy
    from pointnerf_tpu_torch.train.step import (create_train_state,
                                                eval_step, refresh_grid,
                                                train_step)
    cfg = quality_config()
    if cfg.agg.fused_decode or cfg.render.fused_march:
        fail("the quality configuration has a fused flag on")
    dev = torch.device(device)
    prims = SCENES[DS_SCAN]()
    xyz, color, normals = sample_cloud(prims, QUALITY_POINTS, seed=0)
    pc, st = make_point_cloud(xyz, torch.Generator().manual_seed(0),
                              cfg.points, cfg.agg.point_features_dim,
                              color=color, dirs=normals, device=dev)
    params = init_aggregator_params(cfg.agg, torch.Generator().manual_seed(1),
                                    device=dev)
    grid, _ = refresh_grid(pc, st, cfg)
    views = sphere_cameras(8, radius=2.4, focal=875.0, wh=DS_WH, seed=0)
    items = [view_item(prims, *v, DS_WH, n_rays=N_RAYS, seed=i, view_id=i)
             for i, v in enumerate(views)]
    # card vs CPU, the CPU with the flags set (the kernels' plain versions),
    # at random weights from a seed, as phase 5
    flags_on = cfg.replace(
        agg=dataclasses.replace(cfg.agg, fused_decode=True),
        render=dataclasses.replace(cfg.render, fused_march=True))
    parity_batch = ray_batch_from_numpy(view_item(
        prims, *views[5], DS_WH, n_rays=512, seed=7, view_id=5), cfg,
        device=dev)
    cpu_parity(params, pc, st, grid, cfg, cfg_cpu=flags_on,
               b_card=parity_batch)
    state = create_train_state(torch.Generator(device=dev).manual_seed(2),
                               params, pc, cfg)
    tbatch = ray_batch_from_numpy(items[0], cfg, device=dev)
    reset_counts(kernels)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(FLAGS_OFF_WARMUP + FLAGS_OFF_STEPS):
        if i == FLAGS_OFF_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = {n: kernels[n].launches for n in TRAIN_KERNELS}
        if i == 0:
            with recording_decode() as step_inputs:
                state, it = train_step(state, st, grid, tbatch, cfg)
        else:
            state, it = train_step(state, st, grid, tbatch, cfg)
        for n in TRAIN_KERNELS:
            if kernels[n].launches != before[n] + 1:
                fail(f"flags-off train step {i}: {n} launched "
                     f"{kernels[n].launches - before[n]} times, not once")
        losses.append(it["loss_total"])
    torch.cuda.synchronize()
    dt_train = time.perf_counter() - t0
    if kernels["fused_march"].launches:
        fail("flags-off training launched K2 (training takes the plain "
             "march)")
    losses = torch.stack(losses).cpu()
    if not bool(torch.isfinite(losses).all()):
        fail(f"a flags-off training loss is not finite: {losses.tolist()}")
    t1 = time.perf_counter()
    for i in range(FLAGS_OFF_REQUESTS):
        before = {n: kernels[n].launches for n in RENDER_KERNELS}
        b = ray_batch_from_numpy(items[1 + i], cfg, device=dev)
        if i == 0:
            with recording_kernels() as request_inputs:
                out = eval_step(state.params, st, grid, b, cfg)
        else:
            out = eval_step(state.params, st, grid, b, cfg)
        for n in RENDER_KERNELS:
            if kernels[n].launches != before[n] + 1:
                fail(f"flags-off request {i}: {n} launched "
                     f"{kernels[n].launches - before[n]} times, not once")
        if not bool(torch.isfinite(out.coarse_raycolor).all()):
            fail(f"flags-off request {i}: colors not finite")
    torch.cuda.synchronize()
    dt_serve = time.perf_counter() - t1
    counts = {n: k.launches for n, k in kernels.items()}
    routes = kernel_routes(kernels, "flags-off")
    log(f"flags-off path (quality configuration, fused_decode "
        f"{cfg.agg.fused_decode}, fused_march {cfg.render.fused_march}): "
        f"{FLAGS_OFF_STEPS} steps x {N_RAYS} rays after {FLAGS_OFF_WARMUP} "
        f"warm-up steps, {FLAGS_OFF_STEPS * N_RAYS / dt_train:.1f} train "
        f"rays/s; {FLAGS_OFF_REQUESTS} requests in {dt_serve:.4f} s; losses "
        f"{[round(float(v), 6) for v in losses]}; launches {counts}, routes "
        f"{routes}")
    # the same request from the trained state, at its own bar
    cpu_parity(state.params["mlp"], state.params["points"], st, grid, cfg,
               cfg_cpu=flags_on, b_card=parity_batch,
               bar=COLOR_TRAINED_BF16_TOL)
    del state
    all_recorded(step_inputs, "the recorded flags-off train step",
                 ("fused_decode", "fused_decode_bwd"))
    all_recorded(request_inputs, "the recorded flags-off request")
    with torch.no_grad():
        step = {"fused_decode": check_k3(
                    [(step_inputs["fused_decode"], {})],
                    what="flags-off train step")["bf16"],
                "fused_decode_bwd": check_k4(
                    step_inputs["fused_decode_bwd"])["bf16"]}
        del step_inputs
        request = {"knn_select": check_k1(*request_inputs["knn_select"]),
                   "fused_decode": check_k3(
                       [request_inputs["fused_decode"]],
                       what="flags-off request")["bf16"],
                   "fused_march": check_k2(*request_inputs["fused_march"])}
    return counts, routes, {"flags_off_step": step,
                            "flags_off_request": request}


def main() -> None:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    try:
        from pointnerf_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the pointnerf_tpu_torch package is not beside this script "
             f"({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    info = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s for {list(info)}")
    for name, d in info.items():
        lines = [ln for ln in d["log"].splitlines()
                 if "registers" in ln or "spill" in ln or "error" in ln]
        log(f"  {name}: {d['seconds']:.2f} s" + "".join(
            f"\n    {ln.strip()}" for ln in lines))

    cfg = slice_config()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    pc, st, params, grid = make_scene(cfg, dev)
    torch.cuda.synchronize()
    log(f"scene: {N_POINTS} points, {int(grid.num_dil)} dilated cells "
        f"(table rows {grid.nbr_pid.shape[0]}), set-up "
        f"{time.perf_counter() - t0:.2f} s")
    reqs = batches(cfg, N_RAYS, N_REQUESTS, dev)
    seen = [capture_kernel_inputs(params, pc, st, grid, b, cfg) for b in reqs]

    results = {"knn_select": check_k1(*seen[0]["knn_select"]),
               "fused_march": check_k2(*seen[0]["fused_march"])}
    k3 = check_k3([s["fused_decode"] for s in seen])
    results["fused_decode"] = k3["bf16"]     # the main path decodes in bf16

    serve_counts, serve_routes = main_path(params, pc, st, grid, reqs, cfg)
    cpu_parity(params, pc, st, grid, cfg)

    from pointnerf_tpu_torch.train.step import create_train_state
    state = create_train_state(torch.Generator(device=dev).manual_seed(2),
                               params, pc, cfg)
    tbatch = batches(cfg, N_RAYS, 1, dev)[0]      # bench.py's one batch
    k4 = check_k4(capture_k4_inputs(state, st, grid, tbatch, cfg))
    results["fused_decode_bwd"] = k4["bf16"]  # the training path is bf16
    train_counts, train_routes, state = train_path(state, st, grid, tbatch,
                                                   cfg)
    train_cpu_parity(state, st, grid, cfg)
    del state, seen

    maint, maint_counts, maint_routes, _secs, _rate = maintenance_path(
        cfg, kernel_wrappers())
    # each render kernel against its plain version at the shapes the
    # maintenance path gives it: a dense probe chunk and a compacted eval
    # chunk
    chunks = {}
    for kind in ("probe_chunk", "eval_chunk"):
        cap = maint.captured.get(kind)
        if cap is None:
            fail(f"no {kind}'s kernel inputs were recorded")
        chunks[kind] = {
            "knn_select": check_k1(*cap["knn_select"]),
            "fused_march": check_k2(*cap["fused_march"]),
            "fused_decode": check_k3([cap["fused_decode"]],
                                     what=kind.replace("_", " "))["bf16"]}
    maint.captured.clear()
    window_parity(maintenance_config(cfg), maint)
    del maint

    # the dataset path: a generated nerf_synth scene through
    # train_dataset_scene / test_dataset_scene at scene_config()
    data_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "nerf_synth")
    t0 = time.perf_counter()
    write_nerf_synth_scene(os.path.join(data_root, DS_SCAN))
    log(f"nerf_synth scene written under {data_root}: {DS_TRAIN_VIEWS} train "
        f"and {DS_TEST_VIEWS} test views of {DS_WH[0]} x {DS_WH[1]}, "
        f"{DS_POINTS} points, {time.perf_counter() - t0:.2f} s")
    ds, ds_counts, ds_routes, _ds_secs, _psnr = dataset_path(
        kernel_wrappers(), data_root)
    if ds.step_inputs is None or "eval_chunk" not in ds.captured:
        fail("the dataset path's decode inputs were not recorded")
    f32_k3, f32_k4 = check_f32_decode(
        [("train step", ds.step_inputs["fused_decode"]),
         ("eval chunk", ds.captured["eval_chunk"]["fused_decode"][0])],
        ds.step_inputs["fused_decode_bwd"])
    ds_cfg = ds.cfg
    del ds
    query_branches(data_root, ds_cfg)
    voxel_parity()
    fo_counts, fo_routes, fo_checks = flags_off_path(kernel_wrappers())

    csrc = "pointnerf_tpu_torch/csrc/"
    # one row per kernel source: K3 and K4 have two, the tensor-core
    # kernels (bf16) and the CUDA-core kernels (f32), counted by route
    meta = {"knn_select": ("knn_select", None, "knn_select.cu",
                           "pointnerf_tpu/ops/pallas_knn.py:89"),
            "fused_decode": ("fused_decode", "tensor_core",
                             "fused_decode_tc.cu",
                             "pointnerf_tpu/ops/pallas_decode.py:404"),
            "fused_decode_f32": ("fused_decode", "cuda_core",
                                 "fused_decode.cu",
                                 "pointnerf_tpu/ops/pallas_decode.py:404"),
            "fused_march": ("fused_march", None, "fused_march.cu",
                            "pointnerf_tpu/ops/pallas_march.py:69"),
            "fused_decode_bwd": ("fused_decode_bwd", "tensor_core",
                                 "fused_decode_bwd_tc.cu",
                                 "pointnerf_tpu/ops/pallas_decode.py:467"),
            "fused_decode_bwd_f32": ("fused_decode_bwd", "cuda_core",
                                     "fused_decode_bwd.cu",
                                     "pointnerf_tpu/ops/pallas_decode.py:467")}
    # the numbers of each row: at the main paths' shapes for K1, K2 and the
    # tensor-core kernels; the CUDA-core kernels at the dataset path's train
    # step, the shapes they run at on a path
    results["fused_decode_f32"] = {**f32_k3["train step"],
                                   "eval_chunk": f32_k3["eval chunk"],
                                   "bench_request": k3["f32"]}
    results["fused_decode_bwd_f32"] = {**f32_k4, "bench_step": k4["f32"]}
    now = {"K3 f32, train step": f32_k3["train step"]["ms"],
           "K3 f32, eval chunk": f32_k3["eval chunk"]["ms"],
           "K4 f32, train step": f32_k4["ms"]}
    log("f32 route on the dataset path, this run vs the first f32 kernels "
        "(PERF.md §6): " + "; ".join(
            f"{k} {now[k]:.4f} ms vs {v:.4f} ms ({v / now[k]:.1f}x)"
            for k, v in FIRST_F32_MS.items()))
    paths = {"serve": (serve_counts, serve_routes),
             "train": (train_counts, train_routes),
             "maintenance": (maint_counts, maint_routes),
             "dataset": (ds_counts, ds_routes),
             "flags_off": (fo_counts, fo_routes)}
    rows = []
    for row_name, (wrapper, route_name, src, rep) in meta.items():
        r = results[row_name]
        # launches over the main paths' runs, of this source's route
        by_path = {p: (c[wrapper] if route_name is None
                       else rts[wrapper][route_name])
                   for p, (c, rts) in paths.items()}
        row = {"name": row_name, "route": "cuda", "source": csrc + src,
               "replaces": rep, "launches": sum(by_path.values()),
               "launches_by_path": by_path,
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for k in ("host_us", "run_stats", "gemm_chain_ms", "M", "live_rows",
                  "live_group_rows", "live_tile_rows", "eval_chunk",
                  "bench_request", "bench_step"):
            if k in r:
                row[k] = r[k]
        # the same comparison and timing on the maintenance path's dense
        # probe chunk and its eval chunk, and on the flags-off path's train
        # step and request
        for kind, res in ({"maintenance_" + k: v for k, v in chunks.items()}
                          | fo_checks).items():
            if row_name in res:
                row[kind] = {k: v for k, v in res[row_name].items()
                             if k != "gemm_chain_ms"}
        rows.append(row)
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
