"""Image-folder metric evaluation CLI.

Counterpart of `pointnerf_tpu/eval_cli.py`: pairs rendered and
ground-truth images by sorted filename and writes one txt file per metric
plus `scores.txt`. Images are read by extension (8-bit PNG with the port's
PNG reader, JPEG through Pillow). Usage:

    python -m pointnerf_tpu_torch.eval_cli --pred runs/x/images --gt DIR \
        [--metrics psnr ssim rmse lpips lpips_proxy] [--out DIR]
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np

from .utils.metrics import lpips_fn, lpips_proxy, psnr, rmse, ssim
from .utils.visualizer import read_image

_EXT = (".png", ".jpg", ".jpeg")


def load_image(path: str) -> np.ndarray:
    """An image file as [H, W, 3] float32 in [0, 1]."""
    im = read_image(path).astype(np.float32) / 255.0
    if im.ndim == 2:
        im = np.repeat(im[..., None], 3, -1)
    return im[..., :3]


def evaluate_folders(pred: str, gt: str, metrics: List[str],
                     out: Optional[str] = None) -> Dict[str, float]:
    """Mean of each metric over the image pairs; writes `<metric>.txt` (one
    value per pair) and `scores.txt` into `out` (default `pred`). A metric
    that cannot be computed here (lpips without its package) is reported as
    unavailable."""
    preds = sorted(f for f in os.listdir(pred) if f.lower().endswith(_EXT))
    gts = sorted(f for f in os.listdir(gt) if f.lower().endswith(_EXT))
    if len(preds) != len(gts):
        raise SystemExit(f"count mismatch: {len(preds)} pred vs {len(gts)} "
                         "gt")
    out_dir = out or pred
    fns = {"psnr": psnr, "ssim": ssim, "rmse": rmse,
           "lpips_proxy": lpips_proxy}
    if "lpips" in metrics:
        fns["lpips"] = lpips_fn("alex")
    per_metric = {m: [] for m in metrics}
    for pf, gf in zip(preds, gts):
        p = load_image(os.path.join(pred, pf))
        g = load_image(os.path.join(gt, gf))
        for m in metrics:
            if fns.get(m) is not None:
                per_metric[m].append(fns[m](p, g))
    lines, means = [], {}
    for m, vals in per_metric.items():
        if not vals:
            lines.append(f"{m}: unavailable")
            continue
        with open(os.path.join(out_dir, f"{m}.txt"), "w") as f:
            f.write("\n".join(f"{v:.6f}" for v in vals))
        means[m] = float(np.mean(vals))
        lines.append(f"{m}: {means[m]:.6f}")
    with open(os.path.join(out_dir, "scores.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    return means


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pred", required=True)
    ap.add_argument("--gt", required=True)
    ap.add_argument("--metrics", nargs="+",
                    default=["psnr", "ssim", "rmse", "lpips", "lpips_proxy"])
    ap.add_argument("--out", default=None,
                    help="output dir for scores (default: --pred)")
    args = ap.parse_args(argv)
    evaluate_folders(args.pred, args.gt, args.metrics, args.out)


if __name__ == "__main__":
    main()
