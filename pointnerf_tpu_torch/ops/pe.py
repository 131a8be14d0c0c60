"""Positional encoding in the reference layout.

Counterpart of `pointnerf_tpu/ops/pe.py` (`positional_encoding` forward,
`pe_dim`). For input [..., D] and F freqs, base[..., d*F + f] = x_d * 2^f;
the default output [..., 2DF] interleaves (sin(base_0), cos(base_0),
sin(base_1), ...); `ori=True` gives [x, sin(base), cos(base)] in blocks.
"""
from __future__ import annotations

import torch


def _base(x: torch.Tensor, freqs: int) -> torch.Tensor:
    fb = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    return (x[..., None] * fb).reshape(x.shape[:-1] + (x.shape[-1] * freqs,))


def positional_encoding(x: torch.Tensor, freqs: int,
                        ori: bool = False) -> torch.Tensor:
    if freqs <= 0:
        return x
    base = _base(x, freqs)
    if not ori:
        return torch.stack([torch.sin(base), torch.cos(base)], -1).reshape(
            base.shape[:-1] + (2 * base.shape[-1],))
    return torch.cat([x, torch.sin(base), torch.cos(base)], -1)


def pe_dim(d: int, freqs: int, ori: bool = False) -> int:
    if freqs <= 0:
        return d
    return d + 2 * d * freqs if ori else 2 * d * freqs
