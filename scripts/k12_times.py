#!/usr/bin/env python3
"""Device and host times of K1 (KNN select) and K2 (ray-march compositor)
on the main path's inputs, on one CUDA card.

    python3 scripts/k12_times.py [--root DIR] [--rounds N]

Builds chip_smoke.py's scene (65,536-point sphere, bench_config with the
three kernel flags), renders one 3,600-ray request to record K1's and K2's
inputs, holds each kernel against its plain version (K1 bit-equal, K2
within chip_smoke's K2_TOL), then times each kernel `--rounds` times:
device ms per launch from a CUDA graph of 50 launches (chip_smoke.graph_ms)
and host µs per wrapper call; beside them, once, the earlier timing of
back-to-back wrapper calls between two events (chip_smoke.cuda_ms). `--root`
imports pointnerf_tpu_torch from another checkout (an unpacked earlier
commit, say), so two versions are timed on one card: run it once per tree
in one command, in turns. Prints one JSON line last.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose pointnerf_tpu_torch is timed")
    ap.add_argument("--rounds", type=int, default=3)
    a = ap.parse_args()
    sys.path[:0] = [os.path.abspath(a.root), HERE]
    import torch
    if not torch.cuda.is_available():
        sys.exit("k12_times: needs a CUDA card")
    # this checkout's chip_smoke, whichever package --root names
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from pointnerf_tpu_torch.ops import _build
    from pointnerf_tpu_torch.ops.fused_march import (fused_march,
                                                     fused_march_plain)
    from pointnerf_tpu_torch.ops.knn_select import knn_select, knn_select_plain
    card = cs.card_line()
    print(f"card: {card}; package from {_build.CSRC.parent}", flush=True)
    _build.build(["knn_select", "fused_march"])
    cfg = cs.slice_config()
    pc, st, params, grid = cs.make_scene(cfg, torch.device("cuda"))
    batch = cs.batches(cfg, cs.N_RAYS, 1, "cuda")[0]
    seen = cs.capture_kernel_inputs(params, pc, st, grid, batch, cfg)
    k1a, k1k = seen["knn_select"]
    k2a, _ = seen["fused_march"]
    pk, dk = knn_select(*k1a, **k1k)
    pp, dp = knn_select_plain(*k1a, k1k["K"], k1k["r2"])
    k1_equal = bool(torch.equal(pk, pp) and torch.equal(dk, dp))
    k2_err = max(float((x - y).abs().max()) for x, y in
                 zip(fused_march(*k2a), fused_march_plain(*k2a)))
    print(f"K1 bit-equal to plain: {k1_equal}; K2 max abs err {k2_err:.3e}",
          flush=True)
    out = {"card": card, "k1_equal": k1_equal, "k2_err": k2_err,
           "k1_ms": [], "k1_host_us": [], "k2_ms": [], "k2_host_us": []}
    for _ in range(a.rounds):
        out["k1_ms"].append(cs.graph_ms(lambda: knn_select(*k1a, **k1k)))
        out["k2_ms"].append(cs.graph_ms(lambda: fused_march(*k2a)))
        out["k1_host_us"].append(cs.host_us(lambda: knn_select(*k1a, **k1k)))
        out["k2_host_us"].append(cs.host_us(lambda: fused_march(*k2a)))
    # the earlier timing: back-to-back wrapper calls between two events
    out["k1_events_ms"] = cs.cuda_ms(lambda: knn_select(*k1a, **k1k), 20)
    out["k2_events_ms"] = cs.cuda_ms(lambda: fused_march(*k2a), 50)
    print(json.dumps(out), flush=True)
    if not (k1_equal and k2_err <= cs.K2_TOL):
        sys.exit("k12_times: a kernel disagrees with its plain version")


if __name__ == "__main__":
    main()
