"""A tiny cell added to a temporary copy of the benchmark as new files and
entries only (a configuration, two traffic mixes, limits, a workload entry
each), run on the CPU."""
from __future__ import annotations

import dataclasses
import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# limits of the tiny cells, set between the program's readings and the
# control's at this size on the CPU (seeds 21-30: program loss_gap <= 1.3e-3,
# grad_gap <= 0.0094, change_gap <= 0.0061, color_gap <= 0.015; control
# grad_gap >= 0.028, color_gap >= 0.068; the faults change_gap >= 0.19,
# color_gap >= 0.26)
TINY_LIMITS = {
    "train": {"loss_gap": 4e-3, "grad_gap": 0.018, "change_gap": 0.05},
    "render": {"color_gap": 0.04, "mask_mismatch": 0},
}


def tiny_config() -> dict:
    """The tiny test configuration in the layout of a config file."""
    from pointnerf_tpu_torch.config import tiny_test_config
    cfg = tiny_test_config()
    cfg = cfg.replace(
        query=dataclasses.replace(cfg.query, prebuild_neighbors=True,
                                  shell_layered=False, knn_select="pallas",
                                  max_d=4096),
        agg=dataclasses.replace(cfg.agg, fused_decode=True),
        render=dataclasses.replace(cfg.render, fused_march=True),
        train=dataclasses.replace(cfg.train, compute_dtype="bf16"))
    raw = json.loads(cfg.to_json())
    raw["points"]["vox_res"] = 64
    return {"name": "tiny", "source": "tiny_test_config() of the port",
            "reduced": [], "assumed": {},
            "scene": {"kind": "object", "img_wh": [24, 24], "focal": 33.0,
                      "distance": 4.0, "train_views": 8, "test_views": 6,
                      "test_elevation_deg": 30.0, "surface_samples": 4000,
                      "fit_margin": 0.95},
            "pointnerf": raw}


def add_tiny_cells(root: str) -> str:
    """Copy BENCHMARK.json and portbench/ under `root`, then add the tiny
    cells as new files and entries. Returns the copy's root."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = os.path.join(root, "portbench")

    def write(rel, obj):
        path = os.path.join(pb, rel)
        assert not os.path.exists(path), f"{rel} exists: the cell must be new"
        with open(path, "w") as f:
            json.dump(obj, f)
    write("configs/tiny.json", tiny_config())
    with open(os.path.join(ROOT, "portbench", "traffic", "train.json")) as f:
        train = dict(json.load(f), pool_batches=4)
    with open(os.path.join(ROOT, "portbench", "traffic", "render.json")) as f:
        render = dict(json.load(f), chunk=128, checked_hit_rays=16,
                      checked_any_rays=8, readings_frames=2)
    write("traffic/tiny_train.json", train)
    write("traffic/tiny_render.json", render)
    write("limits/tiny.train.json", TINY_LIMITS["train"])
    write("limits/tiny.render.json", TINY_LIMITS["render"])
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny", "source": "tiny_test_config",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    for kind in ("train", "render"):
        bench["workloads"].append({"name": f"tiny.{kind}", "config": "tiny",
                                   "traffic": f"tiny_{kind}", "chips": 1,
                                   "why": "a test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if f"lego.{kind}" in m.get("workloads", []):
                m["workloads"].append(f"tiny.{kind}")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
