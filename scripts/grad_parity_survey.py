#!/usr/bin/env python3
"""Readings of chip_smoke.py's card-vs-CPU training-step gradient check on
several states that its timed training steps leave, each beside its
control: the data from which the check's bars (GRAD_BF16_TOL) are set.

    python3 scripts/grad_parity_survey.py [--states N] [--steps S]

Builds the kernels and the scene of chip_smoke.py, takes its training path
(3 warm-up and 20 timed steps), then at each of N states (default 5) takes
the loss and gradients of a 512-ray step on the card, on the CPU and on the
CPU with an f32 decode (the control) for two batches, and S more training
steps (default 10) before the next state. Prints, per state, batch and
group (mlp, points): the group's sum |err| / sum |CPU| (the metric
chip_smoke holds), its worst leaf's mean |err| / mean |CPU| and max |err| /
max |CPU|, each with the control's. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--states", type=int, default=5)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("no CUDA device is available")
    from pointnerf_tpu_torch.ops import _build
    from pointnerf_tpu_torch.train.step import create_train_state, train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(f"card: {cs.card_line()}")
    _build.build()
    cfg = cs.slice_config()
    dev = torch.device("cuda")
    pc, st, params, grid = cs.make_scene(cfg, dev)
    state = create_train_state(torch.Generator(device=dev).manual_seed(2),
                               params, pc, cfg)
    batch = cs.batches(cfg, cs.N_RAYS, 1, dev)[0]
    _counts, _routes, state = cs.train_path(state, st, grid, batch, cfg)
    for k in range(args.states):
        for seed0 in (11, 12):
            r = cs.train_grads(state, st, grid, cfg, seed0=seed0)
            card = cs.grad_readings(r["card"][1], r["cpu"][1])
            ctl = cs.grad_readings(r["control"][1], r["cpu"][1])
            for grp in ("mlp", "points"):
                (l1, m, mx), (c_l1, cm, cmx) = card[grp], ctl[grp]
                cs.log(f"state {k} (step {int(state.step)}) batch {seed0} "
                       f"{grp}: sum {l1:.3e} (control {c_l1:.3e}), worst "
                       f"leaf mean {m[0]:.3e} {m[1]} (control {cm[0]:.3e}), "
                       f"worst leaf max {mx[0]:.3e} {mx[1]} (control "
                       f"{cmx[0]:.3e})")
        for _ in range(args.steps):
            state, _items = train_step(state, st, grid, batch, cfg)


if __name__ == "__main__":
    main()
