"""Loss-aware training-ray importance sampling.

Counterpart of `pointnerf_tpu/train/sampler.py` (`ErrorMapSampler`, numpy):
each training view keeps a coarse cell error map (cell x cell pixels per
entry, initialised to `init` so unseen regions are drawn first), and
`sample_pixels` draws a `1 - uniform_frac` share of a batch from cells in
proportion to their error EMA and the rest uniformly. The train step's
per-ray squared errors stay on the device in `record`; `flush` moves all
pending ones to the host in one copy.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


class ErrorMapSampler:
    """Per-view cell error maps + importance pixel sampling."""

    def __init__(self, n_views: int, wh: Tuple[int, int], cell: int = 4,
                 uniform_frac: float = 0.5, ema: float = 0.3,
                 init: float = 1.0):
        if cell < 1 or not 0.0 <= uniform_frac <= 1.0:
            raise ValueError(f"need cell >= 1 and 0 <= uniform_frac <= 1, "
                             f"got {cell}, {uniform_frac}")
        W, H = wh
        self.W, self.H, self.cell = W, H, cell
        self.cw = -(-W // cell)
        self.ch = -(-H // cell)
        self.uniform_frac = uniform_frac
        self.ema = ema
        self.maps = np.full((n_views, self.ch * self.cw), init, np.float32)
        self._pending: List[Tuple[int, np.ndarray, torch.Tensor]] = []

    def sample_pixels(self, view: int, n: int,
                      rng: np.random.RandomState) -> np.ndarray:
        """[n, 2] int32 (x, y) pixel indices for one view."""
        n_uni = int(round(n * self.uniform_frac))
        n_imp = n - n_uni
        parts = []
        if n_uni:
            parts.append(np.stack([rng.randint(0, self.W, n_uni),
                                   rng.randint(0, self.H, n_uni)], axis=-1))
        if n_imp:
            # the floor keeps the distribution valid when a view's errors
            # have decayed to exact zero everywhere
            m = self.maps[view] + 1e-12
            p = m / m.sum()
            cells = rng.choice(m.shape[0], size=n_imp, p=p)
            cy, cx = cells // self.cw, cells % self.cw
            x = np.minimum(cx * self.cell + rng.randint(0, self.cell, n_imp),
                           self.W - 1)
            y = np.minimum(cy * self.cell + rng.randint(0, self.cell, n_imp),
                           self.H - 1)
            parts.append(np.stack([x, y], axis=-1))
        return np.concatenate(parts).astype(np.int32)

    def record(self, view: Optional[int], pixel_idx, per_ray_err):
        """Queue one step's per-ray errors (a tensor, left on its device
        until `flush`)."""
        if view is None:
            return
        self._pending.append((int(view), np.asarray(pixel_idx, np.int64),
                              per_ray_err))
        # never hold more than 64 steps of errors however long the log
        # cadence is
        if len(self._pending) >= 64:
            self.flush()

    def flush(self):
        """Move the pending errors to the host (one copy) and EMA them into
        the cell maps."""
        if not self._pending:
            return
        errs = torch.stack([e for _, _, e in self._pending]).cpu().numpy()
        size = self.ch * self.cw
        for (view, pix, _), err in zip(self._pending, errs):
            cells = ((pix[:, 1] // self.cell) * self.cw
                     + pix[:, 0] // self.cell)
            s = np.bincount(cells, weights=err, minlength=size)
            c = np.bincount(cells, minlength=size)
            obs = c > 0
            m = self.maps[view]
            m[obs] = ((1.0 - self.ema) * m[obs]
                      + self.ema * (s[obs] / c[obs]).astype(np.float32))
        self._pending.clear()
