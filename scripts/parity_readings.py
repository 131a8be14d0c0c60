#!/usr/bin/env python3
"""Readings of one of chip_smoke.py's card-vs-CPU parity checks over
several trained states, on the card.

    python3 scripts/parity_readings.py \
        --phase ff|ff_render|n2d|general|hybrid|sharded [--states N]

--phase ff: writes chip_smoke's DTU-format scene under build/, then for
each state trains the feed-forward path anew (chip_smoke's ff_path: its
3 + 10 steps; the card's conv3d backward is not deterministic, so each
state differs) and runs ff_parity on it (split at the cloud). This is how
the bars of FF_TOL were set.

--phase ff_render: as --phase ff, but runs only ff_parity's render of the
card's cloud (ff_render_parity: the loss's rays' shares, the MLPs' and the
cloud's gradients, beside a bf16 decode), ~10 s a state. This is how
FF_TOL's "loss", "mlp" and "dcloud" bars were last set.

--phase n2d: for each state runs chip_smoke's n2d_path anew: its CNN,
StyleGAN2 and GAN steps (the payload gather's backward adds with atomics,
so each run's trained states differ), the feature requests, one CNN and
one GAN step card vs CPU from the trained states, and K3 / K4 bf16 on a
recorded CNN step. This is how the bars of N2D_TOL, N2D_GAN_FIXED_TOL
and TC_K4_BF16_* were set.

--phase general: builds phase 3's sphere scene, then for each of phase
30's general settings (bench_config at H = 512 and at K = 6) trains from
the fresh state, one train step per state on bench.py's one batch, and
holds K4 on the next step's recorded inputs as phase 30 does (check_k4
with hold_general_k4: the general K4 bf16's scratch at every rounding
point, its row gradients per tile against the f64-summed plain version
fed the kernel's leaky-ReLU branches, and dW / db / dwa / dba against
phases B and C's function in f64 on its scratch, each beside its control,
a live tile left out).

--phase hybrid: builds phases 14-16's hole scene once per configuration
(the hybrid, then the hybrid with the fine pass), then for each state
trains it anew from the same fresh state (chip_smoke's warm-up and timed
steps on one batch; the payload gather's backward adds with atomics, so
each run's trained state differs) and runs its 512-ray train step card vs
CPU (hybrid_train_parity: the loss within HYBRID_LOSS_BF16_TOL beside the
CPU's f32 decode, each gradient group at its bar). This is how
HYBRID_LOSS_BF16_TOL was set.

--phase sharded: starts phase 33's two worlds of two ranks (gloo), one
sharing the card and one on the CPU, then for each state runs its (b) and
(d) anew: (b) trains the sharded sphere from the fresh state (its warm-up
and timed steps; the payload gather's backward adds with atomics, so each
run's trained state differs) and holds its 512-ray train step card vs the
CPU world (shard_train_parity), (d) holds the (dp 2, mp 1) step against
the mean of the single-device rows' (shard_dp_parity). This is how
SHARD_TRAIN_TOL and SHARD_DP_TOL were set.

Each reading is printed beside its control and bar. A reading beyond its
bar, or a control under it, is printed, not fatal, so that one run reads
them all. At the end each held quantity's readings are summed up: how
many, the highest reading, the lowest control, the bar, and the geometric
mean of the highest reading and the lowest control.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", required=True,
                    choices=("ff", "ff_render", "n2d", "general", "hybrid",
                             "sharded"))
    ap.add_argument("--states", type=int, default=9)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from pointnerf_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        sys.exit("parity_readings: no CUDA device is available")
    cs.fail = lambda msg: print(f"beyond: {msg}", flush=True)
    held = record_holds(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)
    _build.build()
    kernels = cs.kernel_wrappers()
    if args.phase in ("ff", "ff_render"):
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        root = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
        _ft_root, ff_root = cs.write_dtu_scenes(root)
    if args.phase == "general":
        general_readings(cs, args.states)
    elif args.phase == "hybrid":
        hybrid_readings(cs, args.states)
    elif args.phase == "sharded":
        sharded_readings(cs, args.states)
    else:
        state_readings(cs, args.phase, args.states, kernels,
                       ff_root if args.phase != "n2d" else None)
    summary(held)


# the configuration whose holds are being read, before each held name
TAG = [""]


def record_holds(cs):
    """Wrap chip_smoke.hold_bf16 so that every reading, its control and its
    bar are kept, by the name of what is held (after TAG)."""
    held = {}
    hold = cs.hold_bf16

    def rec(what, err, control, bar, control_is="f32 in place of bf16"):
        held.setdefault(TAG[0] + what, []).append((err, control, bar))
        hold(what, err, control, bar, control_is)
    cs.hold_bf16 = rec
    return held


def summary(held) -> None:
    """Per held quantity: readings, highest reading, lowest control, bar,
    and sqrt(highest reading x lowest control)."""
    print("summary (what: n, highest reading, lowest control, bar, "
          "geometric mean of the two):", flush=True)
    for what, rs in held.items():
        hi = max(r[0] for r in rs)
        lo = min(r[1] for r in rs)
        print(f"  {what}: n {len(rs)}, highest {hi:.3e}, lowest control "
              f"{lo:.3e}, bar {rs[-1][2]:.3e}, geometric mean "
              f"{(hi * lo) ** 0.5:.3e}", flush=True)


def state_readings(cs, phase, states, kernels, ff_root) -> None:
    """--phase ff / ff_render / n2d (module docstring)."""
    for i in range(states):
        t0 = time.perf_counter()
        if phase in ("ff", "ff_render"):
            cs.reset_counts(kernels)
            *_rest, state, cfg, model, _nums = cs.ff_path(kernels, ff_root)
            t0 = time.perf_counter()
            if phase == "ff":
                out = f": {cs.ff_parity(state, cfg, model, ff_root)}"
            else:
                inp = cs.ff_parity_inputs(state, cfg, model, ff_root)
                pc_g, st_g = cs.ff_cloud(model, inp["cap"],
                                         state.params["mvs"],
                                         state.mvs_stats,
                                         inp["b_card"])[1:3]
                out = f": {cs.ff_render_parity(state, cfg, inp, pc_g, st_g)[0]}"
        else:
            cs.n2d_path(kernels)         # logs its readings itself
            out = ""
        print(f"state {i} ({time.perf_counter() - t0:.1f} s){out}",
              flush=True)


def hybrid_readings(cs, states: int) -> None:
    """--phase hybrid (module docstring)."""
    import torch

    from pointnerf_tpu_torch.data.procedural import view_item
    from pointnerf_tpu_torch.models.renderer import ray_batch_from_numpy
    from pointnerf_tpu_torch.train.step import create_train_state, train_step
    dev = torch.device("cuda")
    base = cs.opt_config(cs.HYBRID_OPT)
    for name, cfg, steps in (
            ("hybrid", base, cs.HYBRID_WARMUP + cs.HYBRID_STEPS),
            ("fine", cs.fine_config(base), cs.FINE_WARMUP + cs.FINE_STEPS)):
        prims, pc, st, params, grid, views = cs.hole_scene(cfg, dev)
        tbatch = ray_batch_from_numpy(view_item(
            prims, *views[0], cs.DS_WH, n_rays=cs.N_RAYS, seed=0, view_id=0),
            cfg, device=dev)
        parity_batch = cs.hybrid_parity_batch(cfg, prims, views, params, pc,
                                              st, grid, name)
        TAG[0] = f"{name}: "
        for i in range(states):
            t0 = time.perf_counter()
            state = create_train_state(
                torch.Generator(device=dev).manual_seed(2), params, pc, cfg)
            for _ in range(steps):
                state, _items = train_step(state, st, grid, tbatch, cfg)
            cs.hybrid_train_parity(state, st, grid, cfg, parity_batch)
            print(f"{name} state {i} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        del pc, st, params, grid
        torch.cuda.empty_cache()


def general_readings(cs, states: int) -> None:
    """--phase general (module docstring)."""
    import torch

    from pointnerf_tpu_torch.train.step import create_train_state, train_step
    cfg = cs.slice_config()
    pc, st, _params, grid = cs.make_scene(cfg, torch.device("cuda"))
    tbatch = cs.batches(cfg, cs.N_RAYS, 1, "cuda")[0]
    for name, (akw, qkw) in cs.AGG_GENERAL.items():
        c = cs.agg_config(cfg, akw, qkw)
        state = create_train_state(
            torch.Generator(device="cuda").manual_seed(2), cs.agg_params(c),
            pc, c)
        for i in range(states):
            t0 = time.perf_counter()
            state, _items = train_step(state, st, grid, tbatch, c)
            cs.check_k4(cs.capture_k4_inputs(state, st, grid, tbatch, c),
                        f"{name}, state {i}",
                        hold_largest=cs.hold_general_k4)
            print(f"{name} state {i} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)


def sharded_readings(cs, states: int) -> None:
    """--phase sharded (module docstring)."""
    from pointnerf_tpu_torch.parallel.multihost import World
    with World(cs.SHARD_WORLD, "gloo", device="cuda",
               timeout_s=cs.SHARD_TIMEOUT_S) as card, \
            World(cs.SHARD_WORLD, "gloo", device="cpu",
                  timeout_s=cs.SHARD_TIMEOUT_S) as cpu:
        for i in range(states):
            t0 = time.perf_counter()
            tr = card.run(cs.shard_train_job, "cuda")
            trc = cpu.run(cs.shard_train_cpu_job, [r["params"] for r in tr],
                          tr[0]["num_active"])
            cs.shard_train_parity(tr, trc)
            cs.shard_dp_parity(card.run(cs.shard_dp_job, "cuda"))
            print(f"sharded state {i} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)


if __name__ == "__main__":
    main()
