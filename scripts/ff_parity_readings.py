#!/usr/bin/env python3
"""Readings of chip_smoke.py's feed-forward parity (card vs CPU, split at
the cloud) over several trained states, on the card.

    python3 scripts/ff_parity_readings.py [--states 9]

Writes chip_smoke's DTU-format scene under build/, then for each state
trains the feed-forward path anew (chip_smoke's ff_path: its 3 + 10 steps;
the card's conv3d backward is not deterministic, so each state differs) and
runs ff_parity on it, printing each bar's reading beside its control. A
reading beyond its bar is printed, not fatal, so that one run reads them
all: this is how the bars of FF_TOL were set.
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
    ap.add_argument("--states", type=int, default=9)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from pointnerf_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        sys.exit("ff_parity_readings: no CUDA device is available")
    cs.fail = lambda msg: print(f"beyond: {msg}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)
    _build.build()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    _ft_root, ff_root = cs.write_dtu_scenes(root)
    kernels = cs.kernel_wrappers()
    for i in range(args.states):
        cs.reset_counts(kernels)
        *_rest, state, cfg, model, _nums = cs.ff_path(kernels, ff_root)
        t0 = time.perf_counter()
        out = cs.ff_parity(state, cfg, model, ff_root)
        print(f"state {i} ({time.perf_counter() - t0:.1f} s): {out}",
              flush=True)


if __name__ == "__main__":
    main()
