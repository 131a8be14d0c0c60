"""The numbers that decide `correct`, each held to the limit of its cell
(`portbench/limits/<workload>.json`).

Training cells, over the checked first steps:

- loss_gap: the largest |program loss - reference loss| / |reference loss|
  of a step;
- grad_gap: the worst leaf's |norm of the program's first gradient - norm of
  the reference's| / max(the reference's norm of that leaf, the median
  leaf's);
- change_gap: the same for each leaf's change over the checked steps, over
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's (a leaf with no gradient moves under Adam by round-off
  alone, or not at all where it is frozen).

Render cells, over the answers kept from the window's frames:

- color_gap: the largest |program color - reference color| of a kept ray,
  as a share of the kept rays' mean distance from the background in the
  reference;
- mask_mismatch: kept rays whose hit / miss differs (limit 0).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _rel(a: float, b: float, floor: float) -> float:
    return abs(a - b) / max(abs(b), floor)


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    loss = max(_rel(p, r, 1e-30) for p, r in zip(prog["losses"],
                                                 ref["losses"]))
    g_med = float(np.median(list(ref["grad"].values())))
    grad = max(_rel(prog["grad"][k], v, g_med) for k, v in ref["grad"].items())
    moving = [k for k, v in ref["grad"].items() if v >= 1e-3 * g_med]
    c_med = float(np.median([ref["change"][k] for k in moving]))
    change = max(_rel(prog["change"][k], ref["change"][k], c_med)
                 for k in moving)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def worst_leaves(prog: Dict, ref: Dict) -> Dict[str, str]:
    """Which leaf sets grad_gap and change_gap (for the readings)."""
    g_med = float(np.median(list(ref["grad"].values())))
    moving = [k for k, v in ref["grad"].items() if v >= 1e-3 * g_med]
    c_med = float(np.median([ref["change"][k] for k in moving]))
    return {"grad": max(ref["grad"], key=lambda k: _rel(
                prog["grad"][k], ref["grad"][k], g_med)),
            "change": max(moving, key=lambda k: _rel(
                prog["change"][k], ref["change"][k], c_med))}


def render_numbers(cols: List[np.ndarray], masks: List[np.ndarray],
                   ref_cols: List[np.ndarray], ref_masks: List[np.ndarray],
                   bg: float = 1.0) -> Tuple[Dict[str, float], List[bool]]:
    """The numbers, and per frame its hit / miss mismatches and its widest
    gap. The gaps are shares of the kept rays' mean distance from the
    background in the reference (random weights make a scene's opacity, and
    with it every gap, move by decades from seed to seed)."""
    c, rc = np.concatenate(cols), np.concatenate(ref_cols)
    scale = max(float(np.abs(rc - bg).mean()), 1e-12)
    gap = np.abs(c - rc)
    per_frame = []
    for a, m, b, rm in zip(cols, masks, ref_cols, ref_masks):
        fgap = float(np.abs(a - b).max()) / scale if a.size else 0.0
        per_frame.append((int((m != rm).sum()), fgap))
    mism = sum(bad for bad, _g in per_frame)
    return {"color_gap": float(gap.max()) / scale,
            "mask_mismatch": float(mism)}, per_frame


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    out = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(np.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return ok, out
