#!/usr/bin/env python3
"""Readings of one of chip_smoke.py's card-vs-CPU parity checks over
several trained states, on the card.

    python3 scripts/parity_readings.py --phase ff|n2d|general [--states N]

--phase ff: writes chip_smoke's DTU-format scene under build/, then for
each state trains the feed-forward path anew (chip_smoke's ff_path: its
3 + 10 steps; the card's conv3d backward is not deterministic, so each
state differs) and runs ff_parity on it (split at the cloud). This is how
the bars of FF_TOL were set.

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

Each reading is printed beside its control and bar. A reading beyond its
bar, or a control under it, is printed, not fatal, so that one run reads
them all.
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
    ap.add_argument("--phase", required=True, choices=("ff", "n2d",
                                                        "general"))
    ap.add_argument("--states", type=int, default=9)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from pointnerf_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        sys.exit("parity_readings: no CUDA device is available")
    cs.fail = lambda msg: print(f"beyond: {msg}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)
    _build.build()
    kernels = cs.kernel_wrappers()
    if args.phase == "ff":
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        root = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
        _ft_root, ff_root = cs.write_dtu_scenes(root)
    if args.phase == "general":
        general_readings(cs, args.states)
        return
    for i in range(args.states):
        t0 = time.perf_counter()
        if args.phase == "ff":
            cs.reset_counts(kernels)
            *_rest, state, cfg, model, _nums = cs.ff_path(kernels, ff_root)
            t0 = time.perf_counter()
            out = f": {cs.ff_parity(state, cfg, model, ff_root)}"
        else:
            cs.n2d_path(kernels)         # logs its readings itself
            out = ""
        print(f"state {i} ({time.perf_counter() - t0:.1f} s){out}",
              flush=True)


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


if __name__ == "__main__":
    main()
