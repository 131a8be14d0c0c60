"""Bilinear 2D image sampling at continuous pixel coordinates.

Counterpart of `pointnerf_tpu/ops/sample2d.py` (`bilinear_sample`,
`grid_sample_norm`) in PyTorch's channels-first layout: the image is
[C, H, W] and the samples come out [C, ...]. Four gathered taps with
clipped indices, each out-of-image corner zeroed on its own, then the lerp
in JAX's order (top row, bottom row, then y). Not `F.grid_sample`: its
normalized coordinates add a rounding that the JAX version does not have.
The result is differentiable in the image and in x and y (through the tap
weights), which the feed-forward step needs.
"""
from __future__ import annotations

import torch


def bilinear_sample(img: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """img [C, H, W]; x, y [...] pixel coordinates (x along W, y along H).
    Returns [C, ...]; zero outside [0, W-1] x [0, H-1]."""
    C, H, W = img.shape
    shape = x.shape
    x = x.reshape(-1)
    y = y.reshape(-1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = x - x0
    ty = y - y0
    # clamp before the integer cast, so that a far-off coordinate stays off
    # the image instead of wrapping round the integer range
    x0i = x0.clamp(-2.0, W + 1.0).to(torch.int64)
    y0i = y0.clamp(-2.0, H + 1.0).to(torch.int64)
    flat = img.reshape(C, H * W)

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        return flat.index_select(1, idx) * inb.to(img.dtype)

    v00 = tap(x0i, y0i)
    v01 = tap(x0i + 1, y0i)
    v10 = tap(x0i, y0i + 1)
    v11 = tap(x0i + 1, y0i + 1)
    top = v00 * (1 - tx) + v01 * tx
    bot = v10 * (1 - tx) + v11 * tx
    return (top * (1 - ty) + bot * ty).reshape((C,) + tuple(shape))


def grid_sample_norm(img: torch.Tensor, grid_xy: torch.Tensor,
                     align_corners: bool = True) -> torch.Tensor:
    """Sampling at torch-style normalized coordinates. img [C, H, W];
    grid_xy [..., 2] in [-1, 1]. align_corners=True is the MVSNet
    homography's normalization (x / ((W - 1) / 2) - 1)."""
    H, W = img.shape[1], img.shape[2]
    gx, gy = grid_xy[..., 0], grid_xy[..., 1]
    if align_corners:
        x = (gx + 1.0) * 0.5 * (W - 1)
        y = (gy + 1.0) * 0.5 * (H - 1)
    else:
        x = ((gx + 1.0) * W - 1.0) * 0.5
        y = ((gy + 1.0) * H - 1.0) * 0.5
    return bilinear_sample(img, x, y)
