#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases:
  1. the card's name and power limit (nvidia-smi);
  2. build the four kernels from pointnerf_tpu_torch/csrc (one nvcc per
     source, in parallel) and print the build time and ptxas summary;
  3. the scene of both main paths — a 65,536-point sphere_scene (seed 0),
     its grid with the prebuilt neighbor tables, random aggregator weights
     from a seed — at bench_config with knn_select="pallas",
     fused_decode=True and fused_march=True. The requests are rendered once
     to record each kernel's real inputs; then each kernel is held against
     its plain PyTorch version on the card on those inputs (K1 at C = 36,352
     slots x QP = 243 candidates and K2 at R = 3600 x SR = 80 on the first
     request, K3 at M = 290,816 rows in bf16 and in f32 on every request),
     with its time, the plain version's time and the bound;
  4. the serving path: the launch counts are set to 0, eval_step serves 4
     requests of 3,600 rays (4 views), every kernel's count must grow with
     every request, colors must be finite;
  5. one 512-ray request on the card and the same on the CPU through the
     plain versions: integers equal, colors of the rays that hit within the
     bf16 bar;
  6. one training step records K4's real inputs (M = 290,816 rows and the
     upstream gradients); K4 is held against its plain version on them, in
     bf16 and in f32, on the row gradients and every dW/db, with its time,
     the plain version's time and the bound;
  7. the training path: the launch counts are set to 0, train_step takes 3
     warm-up and 20 timed steps of 3,600 rays on one batch, as bench.py
     does; each step must launch K1, K3 and K4 once each (training takes
     the plain march, as the JAX package does, so K2 is not launched); the
     loss must be finite at every step and the mean of the last 5 below the
     mean of the first 5; prints the train rays/s;
  8. the gradients of one 512-ray training step (the state after phase 7,
     the same jitter draw) on the card and on the CPU: integers equal, the
     loss, the MLP gradients and the point-payload gradients within their
     bf16 bars;
  9. the kernels JSON line, the card line, and the final status line.

Each bf16 bar is also held against a control: the same comparison with the
f32 plain version in place of the bf16 one, which must land above the bar,
so a kernel that skipped a bf16 rounding point would fail.

Any failure exits non-zero before the status line. Without a CUDA device,
or without the pointnerf_tpu_torch package beside it, it exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

# tolerances of the kernel-vs-plain comparisons on the card
K2_TOL = 1e-5          # march: the PERF.md parity bar
K3_F32_TOL = 2e-4      # decode in f32: the parity bar, relative to max|plain|
# bf16 bars sit between the error of a sound run and the control, as read
# on an H100 80GB HBM3 at 700 W (PERF.md): K3 9.0e-8 vs 6.4e-3 (relative),
# colors 2.3e-6 vs 9.8e-5 (absolute)
K3_BF16_TOL = 1e-5     # decode in bf16, relative to max|plain|
COLOR_BF16_TOL = 1e-5  # card vs CPU colors of the rays that hit, bf16 decode
K4_F32_TOL = 2e-4      # decode backward in f32, per gradient, of max|plain|
# K4 in bf16, per gradient of max|plain|: read 9.4e-4 vs control 2.4e-1
K4_BF16_TOL = 1e-2
# card vs CPU training step (bf16 decode), relative: the loss (read 1.1e-6
# vs control 8.3e-4), and each gradient leaf of max|CPU| (MLP 5.3e-3 vs
# 3.0e-1, points 6.6e-3 vs 2.4e-1)
LOSS_BF16_TOL = 1e-4
GRAD_BF16_TOL = 3e-2
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


def hold_bf16(what: str, err: float, control: float, bar: float) -> None:
    """Fail unless the bf16 comparison is under its bar and the control
    (f32 in place of bf16) is above it."""
    log(f"{what}: max err {err:.3e}, control (f32 in place of bf16) "
        f"{control:.3e}, bar {bar:.3e}")
    if not err <= bar:
        fail(f"{what} beyond the bf16 bar")
    if not control > bar:
        fail(f"{what}: the bf16 bar does not tell the control apart")


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


def capture_kernel_inputs(params, pc, st, grid, batch, cfg):
    """Render one request with recording wrappers around the three kernel
    entry points; returns {name: (args, kwargs)} as the path called them."""
    from pointnerf_tpu_torch.models import aggregator, renderer
    from pointnerf_tpu_torch.ops import query
    from pointnerf_tpu_torch.train.step import eval_step
    seen = {}
    spots = [("knn_select", query, "knn_select"),
             ("fused_decode", aggregator, "fused_decode"),
             ("fused_march", renderer, "fused_march")]
    originals = []
    for name, mod, attr in spots:
        real = getattr(mod, attr)
        originals.append((mod, attr, real))

        def rec(*a, _name=name, _real=real, **k):
            seen[_name] = (a, k)
            return _real(*a, **k)
        setattr(mod, attr, rec)
    try:
        eval_step({"mlp": params, "points": pc}, st, grid, batch, cfg)
    finally:
        for mod, attr, real in originals:
            setattr(mod, attr, real)
    missing = [n for n, _, _ in spots if n not in seen]
    if missing:
        fail(f"the main path did not reach {missing}")
    return seen


def check_k1(args, kw):
    import torch
    from pointnerf_tpu_torch.ops.knn_select import knn_select, knn_select_plain
    nbr_xyz, nbr_pid, dslot, centers, ok = args
    K, r2 = kw["K"], kw["r2"]
    C, QP = centers.shape[0], nbr_pid.shape[1]
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
    ms = cuda_ms(lambda: knn_select(*args, **kw), iters=20)
    plain = cuda_ms(lambda: knn_select_plain(*args, K, r2), iters=10)
    # bytes this run's data needs: each distinct table row read once
    # (coordinates + ids), the slots' centers/dslot/ok, the [C, K] outputs
    rows = int(torch.unique(dslot[ok & (dslot >= 0)]).numel())
    nbytes = rows * QP * 16 + C * (12 + 4 + 1) + C * K * 8
    flops = int(ok.sum()) * QP * 8
    b, by = bound_ms(nbytes, flops, PEAK_F32)
    log(f"K1 time {ms:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms "
        f"({by}: {rows} distinct rows), library: none (no single PyTorch "
        f"call computes distance + masked K-selection)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b,
            "bound_by": by, "library_ms": None}


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
    ms = cuda_ms(lambda: fused_march(*args), iters=50)
    plain = cuda_ms(lambda: fused_march_plain(*args), iters=5)
    C = feats.shape[-1] - 1
    nbytes = R * SR * (4 + 1 + 4 * (C + 1)) + 4 * C \
        + R * C * 4 + R * SR * 4 + R * 4
    flops = R * SR * (6 + 3 * C)
    b, by = bound_ms(nbytes, flops, PEAK_F32)
    log(f"K2 time {ms:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms "
        f"({by}), library: none (no single PyTorch call composites)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b,
            "bound_by": by, "library_ms": None}


def check_k3(captured):
    """K3 against its plain version on the decode inputs of every captured
    request, in bf16 and in f32; times and bound on the first request's."""
    import torch
    from pointnerf_tpu_torch.ops.fused_decode import (flops, fused_decode,
                                                      fused_decode_plain)

    def diff(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))
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
            log(f"K3 fused_decode {label}, request {i}, M={feat.shape[0]} "
                f"H={sp.H}: max abs err {err:.3e}, scale max|plain| "
                f"{scale:.3e} (tolerance {tol} x scale)")
            if label == "bf16":
                rel = max(rel, err / scale)
                control = min(control,
                              diff(plain["f32"], plain["bf16"]) / scale)
            elif not err <= tol * scale:
                fail(f"K3 ({label}) disagrees with its plain version")
    hold_bf16(f"K3 bf16 vs plain over {len(captured)} requests, relative",
              rel, control, K3_BF16_TOL)

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
        log(f"K3 {label} time {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b:.4f} ms ({by}: {rows} of {M} rows carry weight), library: "
            f"none (no single PyTorch call computes the decode)")
        res[label] = {"max_abs_err": errs[label], "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                      "library_ms": None}
    return res


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
    for k in kernels.values():
        k.launches = 0
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
    log(f"serving path: {len(reqs)} requests x {N_RAYS} rays in {dt:.4f} s = "
        f"{n / dt:.1f} rays/s (host clock, synchronized), launches {counts}")
    return counts


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


def cpu_parity(params, pc, st, grid, cfg):
    """One 512-ray request on the card and on the CPU (plain versions); the
    control renders it on the CPU with an f32 decode."""
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
    b_card = batches(cfg, 512, 1, "cuda", seed0=7)[0]
    b_cpu = type(b_card)(*[None if t is None else mv(t) for t in b_card])
    o_card = eval_step({"mlp": params, "points": pc}, st, grid, b_card, cfg)
    o_cpu = eval_step({"mlp": params_c, "points": pc_c}, st_c, grid_c, b_cpu,
                      cfg)
    same_integers(o_card, o_cpu)
    cfg32 = cfg.replace(train=dataclasses.replace(cfg.train,
                                                  compute_dtype="f32"))
    o_ctl = eval_step({"mlp": params_c, "points": pc_c}, st_c, grid_c, b_cpu,
                      cfg32)
    hit = o_cpu.ray_mask
    col = mv(o_card.coarse_raycolor)[hit]
    log(f"card vs CPU, 512 rays: integers equal, neighbor-id mismatches 0, "
        f"{int(hit.sum())} rays hit")
    if not bool(hit.any()):
        fail("no ray of the parity request hits the scene")
    hold_bf16("card vs CPU colors of the rays that hit",
              float((col - o_cpu.coarse_raycolor[hit]).abs().max()),
              float((col - o_ctl.coarse_raycolor[hit]).abs().max()),
              COLOR_BF16_TOL)


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
    from pointnerf_tpu_torch.ops.fused_decode import (flops, fused_decode_bwd,
                                                      fused_decode_bwd_plain,
                                                      param_count)
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

    res = {}
    with torch.no_grad():
        names, plain32 = run(fused_decode_bwd_plain, False)
        _, plain16 = run(fused_decode_bwd_plain, True)
        control = max(rel(plain32, plain16))
        for label, plain in (("bf16", plain16), ("f32", plain32)):
            _, out = run(fused_decode_bwd, label == "bf16")
            torch.cuda.synchronize()
            errs = rel(out, plain)
            worst = max(range(len(errs)), key=errs.__getitem__)
            abs_err = max(float((a - b).abs().max())
                          for a, b in zip(out, plain))
            log(f"K4 fused_decode_bwd {label}, M={M} H={spec.H}: max abs "
                f"err {abs_err:.3e}, max err relative to its gradient's "
                f"max|plain| {errs[worst]:.3e} ({names[worst]})")
            if label == "bf16":
                hold_bf16("K4 bf16 vs plain, per gradient, relative",
                          errs[worst], control, K4_BF16_TOL)
            elif not errs[worst] <= K4_F32_TOL:
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
            log(f"K4 {label} time {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {b:.4f} ms ({by}: {rows} of {M} rows carry weight), "
                f"library: none (no single PyTorch call computes the decode "
                f"backward)")
            res[label].update({"ms": ms, "plain_ms": plain_ms,
                               "bound_ms": b, "bound_by": by,
                               "library_ms": None})
    return res


def train_path(state, st, grid, batch, cfg):
    """bench.py's loop: 3 warm-up and 20 timed train steps on one batch.
    Every step must launch K1, K3 and K4 once each; the loss must be finite
    and fall. Returns (launch counts, final state)."""
    import torch
    from pointnerf_tpu_torch.train.step import train_step
    kernels = kernel_wrappers()
    for k in kernels.values():
        k.launches = 0
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
        f"{counts}")
    return counts, state


def train_cpu_parity(state, st, grid, cfg):
    """The gradients of one 512-ray training step on the card and on the CPU
    (plain versions), from the same state with the same jitter draw; the
    control takes them on the CPU with an f32 decode."""
    import torch
    from pointnerf_tpu_torch.models.renderer import render_rays
    from pointnerf_tpu_torch.train.optim import tree_leaves, tree_map
    from pointnerf_tpu_torch.train.step import loss_and_grads
    cpu = torch.device("cpu")
    params_c = tree_map(lambda t: t.to(cpu), state.params)
    st_c = type(st)(*[t.to(cpu) for t in st])
    grid_c = type(grid)(*[None if t is None else t.to(cpu) for t in grid])
    dev = state.step.device
    b_card = batches(cfg, 512, 1, dev, seed0=11)[0]
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
    log(f"card vs CPU train step, 512 rays: integers equal, "
        f"{int(o_cpu.ray_mask.sum())} rays hit, loss {float(t_cpu):.6f}")

    def rel_leaves(a_tree, b_tree):
        worst = 0.0
        for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
            a = a.to(cpu)
            scale = float(b.abs().max())
            if scale == 0:
                if float(a.abs().max()) != 0:
                    fail("train step: a gradient is zero on the CPU only")
                continue
            worst = max(worst, float((a - b).abs().max()) / scale)
        return worst
    hold_bf16("card vs CPU train loss, relative",
              abs(float(t_card) - float(t_cpu)) / abs(float(t_cpu)),
              abs(float(t_ctl) - float(t_cpu)) / abs(float(t_cpu)),
              LOSS_BF16_TOL)
    for grp in ("mlp", "points"):
        hold_bf16(f"card vs CPU {grp} gradients, per leaf, relative",
                  rel_leaves(g_card[grp], g_cpu[grp]),
                  rel_leaves(g_ctl[grp], g_cpu[grp]), GRAD_BF16_TOL)


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

    serve_counts = main_path(params, pc, st, grid, reqs, cfg)
    cpu_parity(params, pc, st, grid, cfg)

    from pointnerf_tpu_torch.train.step import create_train_state
    state = create_train_state(torch.Generator(device=dev).manual_seed(2),
                               params, pc, cfg)
    tbatch = batches(cfg, N_RAYS, 1, dev)[0]      # bench.py's one batch
    k4 = check_k4(capture_k4_inputs(state, st, grid, tbatch, cfg))
    results["fused_decode_bwd"] = k4["bf16"]  # the training path is bf16
    train_counts, state = train_path(state, st, grid, tbatch, cfg)
    train_cpu_parity(state, st, grid, cfg)

    meta = {"knn_select": ("pointnerf_tpu_torch/csrc/knn_select.cu",
                           "pointnerf_tpu/ops/pallas_knn.py:89"),
            "fused_decode": ("pointnerf_tpu_torch/csrc/fused_decode.cu",
                             "pointnerf_tpu/ops/pallas_decode.py:404"),
            "fused_march": ("pointnerf_tpu_torch/csrc/fused_march.cu",
                            "pointnerf_tpu/ops/pallas_march.py:69"),
            "fused_decode_bwd": ("pointnerf_tpu_torch/csrc/fused_decode_bwd.cu",
                                 "pointnerf_tpu/ops/pallas_decode.py:467")}
    rows = []
    for name, (src, rep) in meta.items():
        r = results[name]
        # launches over both main paths' runs: the serving requests and the
        # training steps
        by_path = {"serve": serve_counts[name], "train": train_counts[name]}
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": sum(by_path.values()),
                     "launches_by_path": by_path,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
