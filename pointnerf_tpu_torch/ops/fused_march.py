"""K2: single-pass ray-march compositor (radiance render, alpha blend).

Replaces `pointnerf_tpu/ops/pallas_march.py::pallas_ray_march` (forward).
On CUDA tensors `fused_march` launches `csrc/fused_march.cu`; on CPU tensors
it runs `fused_march_plain`, the same sequential walk in PyTorch ops. The
JAX backward recomputes through the plain march and has no kernel; training
in the port takes the plain march under autograd, as the JAX package does
(`models/renderer.py::_finalize`), so only serving launches the kernel.

The kernel stages a tile of `rays_per_block` rays' features in shared
memory with 16-byte loads, so `feats` must be 16-byte aligned.

dist [R, SR] f32, valid [R, SR] bool, feats [R, SR, 1+C] f32, bg [C] f32 ->
(ray_color [R, C], opacity [R, SR], background_transmission [R, 1]).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_C = 8
# the kernel's block: its shared memory (an H100 block takes at most 227 KB)
# holds a tile of rays, each SR * (C + 1) features and SR opacities (each
# stride made odd)
SMEM_BYTES = 232448
TILE_RAYS = (8, 4)


def smem_bytes(rays: int, SR: int, C: int) -> int:
    return rays * ((SR * (C + 1) | 1) + (SR | 1)) * 4


def rays_per_block(SR: int, C: int) -> int:
    """Rays per block of the kernel: the most of TILE_RAYS whose tile fits
    in shared memory, or 0 when none does."""
    for rays in TILE_RAYS:
        if smem_bytes(rays, SR, C) <= SMEM_BYTES:
            return rays
    return 0


def fused_march_plain(dist, valid, feats, bg):
    sigma = feats[..., 0] * valid.to(feats.dtype)
    opacity = 1.0 - torch.exp(-sigma * dist)
    R, SR = dist.shape
    trans = torch.ones(R, dtype=dist.dtype, device=dist.device)
    acc = torch.zeros((R, feats.shape[-1] - 1), dtype=dist.dtype,
                      device=dist.device)
    for s in range(SR):
        op = opacity[:, s]
        acc = acc + feats[:, s, 1:] * (op * trans)[:, None]
        trans = trans * (1.0 - op + 1e-10)
    return acc + bg[None, :] * trans[:, None], opacity, trans[:, None]


def _lib():
    f = _build.load("fused_march").fused_march_launch
    if f.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp, vp, vp, vp]
        f.restype = ci
    return f


def fused_march(dist, valid, feats, bg):
    R, SR = dist.shape
    C = feats.shape[-1] - 1
    dev = dist.device
    for name, t, dt, shape in (("dist", dist, torch.float32, (R, SR)),
                               ("valid", valid, torch.bool, (R, SR)),
                               ("feats", feats, torch.float32, (R, SR, C + 1)),
                               ("bg", bg, torch.float32, (C,))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"fused_march: {name} must be a contiguous {dt} {shape} "
                f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if dev.type == "cpu":
        return fused_march_plain(dist, valid, feats, bg)
    if C > MAX_C:
        raise ValueError(f"fused_march: the CUDA kernel takes C <= {MAX_C}, "
                         f"got {C}")
    rays = rays_per_block(SR, C)
    if not rays:
        raise ValueError(f"fused_march: a tile of {TILE_RAYS[-1]} rays of "
                         f"SR={SR} samples and C={C} channels exceeds the "
                         f"kernel's shared memory")
    if feats.data_ptr() % 16:
        raise ValueError("fused_march: the CUDA kernel reads feats with "
                         "16-byte loads; it must be 16-byte aligned")
    color = torch.empty((R, C), dtype=torch.float32, device=dev)
    opacity = torch.empty((R, SR), dtype=torch.float32, device=dev)
    bgtr = torch.empty((R, 1), dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _lib()(p(dist), p(valid.view(torch.uint8)), p(feats), p(bg), R, SR,
                 C, rays, p(color), p(opacity), p(bgtr),
                 _build.stream_handle(dev))
    _build.check(err, "fused_march")
    fused_march.launches += 1
    return color, opacity, bgtr


fused_march.launches = 0
