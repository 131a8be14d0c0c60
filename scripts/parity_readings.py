#!/usr/bin/env python3
"""Readings of one of chip_smoke.py's card-vs-CPU parity checks over
several trained states, on the card.

    python3 scripts/parity_readings.py --phase ff|n2d [--states N]

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
    ap.add_argument("--phase", required=True, choices=("ff", "n2d"))
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


if __name__ == "__main__":
    main()
