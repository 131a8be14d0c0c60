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
     slots x QP = 243 candidates and K2 at R = 3600 x SR = 80 on the first
     request, K3 at M = 290,816 rows in bf16 and in f32 on every request),
     with its time, the plain version's time and the bound; beside K3 and
     K4, as a printed yardstick only, the same layer products as a chain of
     bf16 torch.matmul calls (gemm_chain_ms), which the port never calls;
  4. the serving path: the launch counts are set to 0, eval_step serves 4
     requests of 3,600 rays (4 views), every kernel's count must grow with
     every request and every decode launch must take the tensor-core route,
     colors must be finite;
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
     does; each step must launch K1, K3 and K4 once each, K3 and K4 on the
     tensor-core route (training takes the plain march, as the JAX package
     does, so K2 is not launched); the
     loss must be finite at every step and the mean of the last 5 below the
     mean of the first 5; prints the train rays/s;
  8. the gradients of one 512-ray training step on the card and on the CPU
     (the same jitter draw) from the state the timed steps left: integers
     equal, the loss, the MLP gradients and the point-payload gradients
     within their bf16 bars;
  9. the kernels JSON line, the card line, and the final status line.

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
import dataclasses
import json
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
K4_F32_TOL = 2e-4      # decode backward in f32, per gradient, of max|plain|
K4_BF16_TOL = 5e-3     # decode backward in bf16, mean relative error
# K3 and K4 in bf16 are also held on their largest error, output by output
# and gradient by gradient (hold_max): at most MAX_FACTOR times the largest
# distance of the f64-summed plain version from the f32 one, plus the f32
# route's bar for a sum in another order. A fault confined to a few rows (a
# live tile taken for dead, or left out of dW) shows there, not in the mean.
MAX_FACTOR = 2.0
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
    log(f"{what}: {err:.3e}, control (f32 in place of bf16) "
        f"{control:.3e}, bar {bar:.3e}")
    if not err <= bar:
        fail(f"{what} beyond the bf16 bar")
    if not control > bar:
        fail(f"{what}: the bf16 bar does not tell the control apart")


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
                log(f"K3 fused_decode bf16, request {i}, M={feat.shape[0]} "
                    f"H={sp.H}: mean |err| / mean |plain| {m:.3e} (worst "
                    f"output), max abs err {err:.3e}")
                # the order-independent reference: the plain version with
                # its sums in f64, the same rounding points
                hold_max(f"K3 bf16, request {i}", ("fagg", "alpha"), out,
                         plain[label],
                         fused_decode_plain(feat, dists, extras, w, params,
                                            sp, dtype=torch.float64),
                         K3_F32_TOL)
                rel = max(rel, m)
                control = min(control, worst_mean(plain["f32"],
                                                  plain["bf16"]))
            else:
                log(f"K3 fused_decode f32, request {i}, M={feat.shape[0]} "
                    f"H={sp.H}: max abs err {err:.3e}, scale max|plain| "
                    f"{scale:.3e} (tolerance {tol} x scale)")
                if not err <= tol * scale:
                    fail(f"K3 ({label}) disagrees with its plain version")
    hold_bf16(f"K3 bf16 vs plain over {len(captured)} requests, mean |err| / "
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
    routes = decode_routes(kernels, "serving")
    log(f"serving path: {len(reqs)} requests x {N_RAYS} rays in {dt:.4f} s = "
        f"{n / dt:.1f} rays/s (host clock, synchronized), launches {counts}, "
        f"decode routes {routes}")
    return counts, routes


def reset_counts(kernels):
    from pointnerf_tpu_torch.ops.fused_decode import reset_launches
    for k in kernels.values():
        k.launches = 0
    reset_launches()


def decode_routes(kernels, path: str):
    """The decode launches of a main-path run by route; fails unless every
    one went to the tensor-core kernels (the main paths decode in bf16)."""
    routes = {n: dict(kernels[n].launches_by_route)
              for n in ("fused_decode", "fused_decode_bwd")}
    for n, r in routes.items():
        if r["cuda_core"] or r["tensor_core"] != kernels[n].launches:
            fail(f"{path} path: {n} launches went to another route than the "
                 f"tensor-core kernels: {r}")
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
    routes = decode_routes(kernels, "training")
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
        f"{counts}, decode routes {routes}")
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

    csrc = "pointnerf_tpu_torch/csrc/"
    meta = {"knn_select": ("knn_select.cu", "pointnerf_tpu/ops/pallas_knn.py:89"),
            "fused_decode": ("fused_decode_tc.cu",
                             "pointnerf_tpu/ops/pallas_decode.py:404"),
            "fused_march": ("fused_march.cu",
                            "pointnerf_tpu/ops/pallas_march.py:69"),
            "fused_decode_bwd": ("fused_decode_bwd_tc.cu",
                                 "pointnerf_tpu/ops/pallas_decode.py:467")}
    # K3 and K4 per precision: bf16 (the main paths) on the tensor-core
    # kernels, f32 on the CUDA-core kernels
    by_precision = {
        "fused_decode": {"bf16": ("fused_decode_tc.cu", k3["bf16"]),
                         "f32": ("fused_decode.cu", k3["f32"])},
        "fused_decode_bwd": {"bf16": ("fused_decode_bwd_tc.cu", k4["bf16"]),
                             "f32": ("fused_decode_bwd.cu", k4["f32"])}}
    routes = {n: {"serve": serve_routes[n], "train": train_routes[n]}
              for n in by_precision}
    rows = []
    for name, (src, rep) in meta.items():
        r = results[name]
        # launches over both main paths' runs: the serving requests and the
        # training steps
        by_path = {"serve": serve_counts[name], "train": train_counts[name]}
        row = {"name": name, "route": "cuda", "source": csrc + src,
               "replaces": rep, "launches": sum(by_path.values()),
               "launches_by_path": by_path,
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if name in by_precision:
            row["gemm_chain_ms"] = r["gemm_chain_ms"]
            row["launches_by_route"] = routes[name]
            row["by_precision"] = {
                p: {"kernel_route": "tensor_core" if p == "bf16"
                    else "cuda_core", "source": csrc + f, **v}
                for p, (f, v) in by_precision[name].items()}
        rows.append(row)
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
