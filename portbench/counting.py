"""The yardstick's arithmetic: the card's peaks, the least time a kernel
could take, and the operations and bytes each kernel's inputs need.

Frozen copies, so that a change to the program cannot move the yardstick:

- the peaks, `bound_ms` (here in seconds), `decode_bound`, `check_k1`'s and
  `k1_run_stats`' counts and `check_k2`'s count from `chip_smoke.py`,
  commit 9ce5b3a;
- `layer_inputs`, `flops` and `param_count` from
  `pointnerf_tpu_torch/ops/fused_decode.py`, commit 9ce5b3a, over a plain
  tuple of the decode's widths in place of the program's `DecodeSpec`.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

HBM_BYTES_PER_S = 3.35e12      # NVIDIA H100 SXM data sheet
PEAK_BF16 = 989e12             # dense bf16 tensor-core rate
PEAK_F32 = 67e12               # f32 outside the tensor cores
K1_DEAD = 1.0e7                # a table candidate with x >= this is empty


class Widths(NamedTuple):
    """The fused decode's widths (the program's DecodeSpec, by value)."""
    Fi: int
    Dd: int
    E: int
    Ff: int
    Fd: int
    H: int
    K: int
    L1: int
    L3: int
    bf16: bool

    @property
    def x1(self) -> int:
        de = 2 * self.Fd * self.Dd if self.Fd > 0 else self.Dd
        return self.Fi + 2 * self.Ff * self.Fi + de


def widths_of(spec) -> Widths:
    """The widths of a DecodeSpec-like object (read by attribute)."""
    return Widths(*(getattr(spec, f) for f in Widths._fields))


def bound_s(nbytes: float, flops: float, peak: float):
    """(least seconds, "bytes" or "operations")."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = flops / peak
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def layer_inputs(w: Widths) -> List[int]:
    """Input width of each block layer: x1, H, ..., H + E, H, ..."""
    return [w.x1] + [w.H] * (w.L1 - 1) + [w.H + w.E] + [w.H] * (w.L3 - 1)


def decode_flops(rows: int, w: Widths) -> int:
    """Multiply-adds x 2 of the per-point MLPs (block1, block3, alpha) for
    `rows` rows."""
    return 2 * rows * (sum(d * w.H for d in layer_inputs(w)) + w.H)


def param_count(w: Widths) -> int:
    """Floats of the block1 / block3 / alpha weights and biases."""
    return sum(n * w.H + w.H for n in layer_inputs(w)) + w.H + 1


def decode_bound(rows: int, M: int, w: Widths, backward: bool = False):
    """(bytes, operations, least seconds, bound by) of one K3 call, or with
    `backward` of one K4 call. Rows: those with a nonzero weight (a row
    without weight has all-zero gradients), each read once, with the weights
    and the outputs written once; K4 also reads the upstream gradients and
    writes all M gradient rows and every dW / db, and does 3x K3's
    operations (the forward again, dW, and the input gradients)."""
    width = w.Fi + w.Dd + w.E + 1
    nbytes = rows * width * 4 + param_count(w) * 4 + (M // w.K) * (w.H + 1) * 4
    ops = decode_flops(rows, w)
    if backward:
        nbytes += M * 4 + M * width * 4 + param_count(w) * 4
        ops *= 3
    t, by = bound_s(nbytes, ops, PEAK_BF16 if w.bf16 else PEAK_F32)
    return nbytes, ops, t, by


def color_flops(samples: int, dims: List[int]) -> int:
    """Multiply-adds x 2 of the color MLP (layer widths `dims`, input
    first) on `samples` shading samples."""
    return 2 * samples * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def k1_bound(stats: Dict, C: int, QP: int, K: int):
    """(bytes, operations, least seconds, bound by) of one K1 call from the
    statistics of its inputs (`k1_stats`): x of every candidate of the
    distinct rows the selecting slots read, y and z of their live ones, the
    ids of the winners (distinct row and id), the centers of the selecting
    slots, every slot's dslot and ok, the [C, K] outputs; operations: d2 of
    each selecting slot's live candidates."""
    nbytes = (stats["distinct_rows"] * QP * 4 + stats["live_in_rows"] * 8
              + stats["winners"] * 4 + stats["selecting"] * 12 + C * (4 + 1)
              + C * K * 8)
    flops = stats["live_of_selecting"] * 8
    t, by = bound_s(nbytes, flops, PEAK_F32)
    return nbytes, flops, t, by


def k1_stats(nbr_xyz, dslot, ok, pid) -> Dict[str, int]:
    """What one K1 call's inputs hold (torch tensors, read after the call):
    the selecting slots (ok and a row), the distinct rows they read, the
    live candidates of those rows, the live candidates summed over the
    selecting slots, and the distinct (row, winner) pairs."""
    import torch
    QP = nbr_xyz.shape[1] // 3
    sel = ok & (dslot >= 0)
    rows = dslot[sel].long()
    n = int(rows.numel())
    if n == 0:
        return {"selecting": 0, "distinct_rows": 0, "live_in_rows": 0,
                "live_of_selecting": 0, "winners": 0}
    distinct, counts = torch.unique(rows, return_counts=True)
    live = (nbr_xyz[distinct, :QP] < K1_DEAD).sum(1)
    win = pid[sel]
    keys = rows[:, None] * 2 ** 32 + win.long()
    return {"selecting": n, "distinct_rows": int(distinct.numel()),
            "live_in_rows": int(live.sum()),
            "live_of_selecting": int((live * counts).sum()),
            "winners": int(torch.unique(keys[win >= 0]).numel())}


def k2_bound(R: int, SR: int, C: int):
    """(bytes, operations, least seconds, bound by) of one K2 call."""
    nbytes = (R * SR * (4 + 1 + 4 * (C + 1)) + 4 * C + R * C * 4
              + R * SR * 4 + R * 4)
    flops = R * SR * (6 + 3 * C)
    t, by = bound_s(nbytes, flops, PEAK_F32)
    return nbytes, flops, t, by
