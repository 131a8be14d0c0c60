#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases:
  1. the card's name and power limit (nvidia-smi);
  2. build the three kernels from pointnerf_tpu_torch/csrc (one nvcc per
     source, in parallel) and print the build time and ptxas summary;
  3. the scene of the main path — a 65,536-point sphere_scene (seed 0), its
     grid with the prebuilt neighbor tables, random aggregator weights from a
     seed — at bench_config with knn_select="pallas", fused_decode=True and
     fused_march=True. The requests are rendered once to record each
     kernel's real inputs; then each kernel is held against its plain
     PyTorch version on the card on those inputs (K1 at C = 36,352 slots x
     QP = 243 candidates and K2 at R = 3600 x SR = 80 on the first request,
     K3 at M = 290,816 rows in bf16 and in f32 on every request), with its
     time, the plain version's time and the bound;
  4. the main path: the launch counts are set to 0, eval_step serves 4
     requests of 3,600 rays (4 views), every kernel's count must grow with
     every request, colors must be finite;
  5. one 512-ray request on the card and the same on the CPU through the
     plain versions: integers equal, colors of the rays that hit within the
     bf16 bar;
  6. the kernels JSON line, the card line, and the final status line.

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
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_BF16 = 989e12             # dense bf16 tensor-core rate
PEAK_F32 = 67e12               # f32 outside the tensor cores

N_POINTS = 65536
N_RAYS = 3600
N_REQUESTS = 4


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


def main_path(params, pc, st, grid, reqs, cfg):
    import torch
    from pointnerf_tpu_torch.ops.fused_decode import fused_decode
    from pointnerf_tpu_torch.ops.fused_march import fused_march
    from pointnerf_tpu_torch.ops.knn_select import knn_select
    from pointnerf_tpu_torch.train.step import eval_step
    kernels = {"knn_select": knn_select, "fused_decode": fused_decode,
               "fused_march": fused_march}
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
            if k.launches <= before[n]:
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
    log(f"main path: {len(reqs)} requests x {N_RAYS} rays in {dt:.4f} s = "
        f"{n / dt:.1f} rays/s (host clock, synchronized), launches {counts}")
    return counts


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
    for f in ("ray_valid", "ray_mask", "decode_dropped"):
        if not torch.equal(mv(getattr(o_card, f)), getattr(o_cpu, f)):
            fail(f"{f} differs between the card and the CPU")
    pk, pc_ = mv(o_card.neighbor_pidx), o_cpu.neighbor_pidx
    bad_rows = (pk != pc_).any(-1).nonzero()[:, 0].tolist()
    if bad_rows:
        # an equal id set in another order can only come from a d2 tie
        for r in bad_rows[:20]:
            tie = sorted(pk[r].tolist()) == sorted(pc_[r].tolist())
            log(f"  slot {r}: card {pk[r].tolist()} cpu {pc_[r].tolist()} "
                f"({'same set: a d2 tie' if tie else 'different sets'})")
        fail(f"neighbor ids differ between the card and the CPU in "
             f"{len(bad_rows)} slots")
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

    counts = main_path(params, pc, st, grid, reqs, cfg)
    cpu_parity(params, pc, st, grid, cfg)

    meta = {"knn_select": ("pointnerf_tpu_torch/csrc/knn_select.cu",
                           "pointnerf_tpu/ops/pallas_knn.py:89"),
            "fused_decode": ("pointnerf_tpu_torch/csrc/fused_decode.cu",
                             "pointnerf_tpu/ops/pallas_decode.py:404"),
            "fused_march": ("pointnerf_tpu_torch/csrc/fused_march.cu",
                            "pointnerf_tpu/ops/pallas_march.py:69")}
    rows = []
    for name, (src, rep) in meta.items():
        r = results[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": counts[name],
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
