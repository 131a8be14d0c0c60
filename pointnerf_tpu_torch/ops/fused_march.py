"""K2: single-pass ray-march compositor (radiance render, alpha blend).

Replaces `pointnerf_tpu/ops/pallas_march.py::pallas_ray_march` (forward).
On CUDA tensors `fused_march` launches `csrc/fused_march.cu`; on CPU tensors
it runs `fused_march_plain`, the same sequential walk in PyTorch ops. The
JAX backward recomputes through the plain march and has no kernel; training
in the port takes the plain march under autograd, as the JAX package does
(`models/renderer.py::_finalize`), so only serving launches the kernel.

Two kernels in one source, picked by the shape. Up to `MAX_C` channels,
where a tile of rays fits in shared memory (`rays_per_block`), the tiled
kernel stages `rays_per_block` rays' features with 16-byte loads, so
`feats` must be 16-byte aligned. Any other shape (the feature renders of
the 2D heads, C = 128) takes the wide kernel: a warp per ray, nothing
staged, any C and SR. Both give the plain version's bits.

dist [R, SR] f32, valid [R, SR] bool, feats [R, SR, 1+C] f32, bg [C] f32 ->
(ray_color [R, C], opacity [R, SR], background_transmission [R, 1]).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# the tiled kernel's most channels (one instance per C); wider rays take
# the wide kernel
MAX_C = 8
# the tiled kernel's block: its shared memory (an H100 block takes at most
# 227 KB) holds a tile of rays, each SR * (C + 1) features and SR
# opacities (each stride made odd)
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


def route(SR: int, C: int) -> str:
    """The kernel a march of this shape launches: "tiled" (C <= MAX_C and a
    tile of rays fits in shared memory) or "wide"."""
    return "tiled" if C <= MAX_C and rays_per_block(SR, C) else "wide"


def _lib(name: str):
    f = getattr(_build.load("fused_march"), name)
    if f.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        ints = [ci] * (4 if name == "fused_march_launch" else 3)
        f.argtypes = [vp, vp, vp, vp] + ints + [vp, vp, vp, vp]
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
    kind = route(SR, C)
    if kind == "tiled" and feats.data_ptr() % 16:
        raise ValueError("fused_march: the tiled CUDA kernel reads feats "
                         "with 16-byte loads; it must be 16-byte aligned")
    color = torch.empty((R, C), dtype=torch.float32, device=dev)
    opacity = torch.empty((R, SR), dtype=torch.float32, device=dev)
    bgtr = torch.empty((R, 1), dtype=torch.float32, device=dev)
    p = _build.ptr
    ins = (p(dist), p(valid.view(torch.uint8)), p(feats), p(bg), R, SR, C)
    outs = (p(color), p(opacity), p(bgtr), _build.stream_handle(dev))
    if kind == "tiled":
        err = _lib("fused_march_launch")(*ins, rays_per_block(SR, C), *outs)
    else:
        err = _lib("fused_march_wide_launch")(*ins, *outs)
    _build.check(err, "fused_march")
    fused_march.launches += 1
    fused_march.launches_by_route[kind] += 1
    return color, opacity, bgtr


fused_march.launches = 0
fused_march.launches_by_route = {"tiled": 0, "wide": 0}
