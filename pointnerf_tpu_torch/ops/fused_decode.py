"""K3: fused decode forward — PE -> block1 -> [h, extras] -> block3 ->
per-point alpha -> weighted K-reduction, per neighbor row.

Replaces the forward of `pointnerf_tpu/ops/pallas_decode.py::fused_decode`
(`_fwd_impl` / `_fwd_kernel` / `_forward_tile` / `_build_x`). On CUDA
tensors `fused_decode` launches `csrc/fused_decode.cu`; on CPU tensors it
runs `fused_decode_plain`. The backward (K4) comes with training.

x per row is laid out exactly as `models/aggregator.aggregate` builds it:
[feat | PE(feat) | PE(dists)] with the interleaved (sin, cos) per
(channel, freq) layout of `ops/pe.py`, so the first block1 weight is used as
the JAX parameters hold it (no row permutation).

With `spec.bf16` the function rounds where the JAX kernel rounds: feat,
dists, extras and w to bf16 before anything else (`_pack_raw`), PE from the
rounded values, x and every hidden activation to bf16, the block weights to
bf16; products accumulate in f32, and the alpha head is f32 against an f32
weight. Both versions here round at the same places.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple

import torch

from . import _build
from .pe import positional_encoding

TILE_ROWS = 64          # rows per CTA in csrc/fused_decode.cu
MAX_LAYERS = 8          # L1 + L3 the kernel's parameter block holds
SMEM_BYTES = 232448     # per-block shared memory the H100 grants


class DecodeSpec(NamedTuple):
    Fi: int          # feature channels
    Dd: int          # dists channels
    E: int           # extra block3 channels (color 3 + dir 4)
    Ff: int          # num_feat_freqs
    Fd: int          # |dist_xyz_freq|
    H: int           # shading_feature_num
    K: int           # neighbors per shading point
    L1: int          # block1 layers
    L3: int          # block3 layers
    neg_slope: float
    bf16: bool

    @property
    def x1(self) -> int:
        de = 2 * self.Fd * self.Dd if self.Fd > 0 else self.Dd
        return self.Fi + 2 * self.Ff * self.Fi + de


def _round(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32) if bf16 else t


def build_x(feat, dists, spec: DecodeSpec) -> torch.Tensor:
    parts = [feat]
    if spec.Ff > 0:
        parts.append(positional_encoding(feat, spec.Ff))
    parts.append(positional_encoding(dists, spec.Fd) if spec.Fd > 0
                 else dists)
    return torch.cat(parts, -1)


def prep_weights(params: Dict, spec: DecodeSpec):
    """Aggregator params -> (Ws, bs, wa [H], ba [1]) as contiguous f32
    tensors; block weights rounded to bf16 values in bf16 mode."""
    Ws, bs = [], []
    for name in ("block1", "block3"):
        for layer in params[name]:
            Ws.append(_round(layer["w"].float(), spec.bf16).contiguous())
            bs.append(layer["b"].float().contiguous())
    wa = params["alpha"][0]["w"].float().reshape(-1).contiguous()
    ba = params["alpha"][0]["b"].float().reshape(1).contiguous()
    return Ws, bs, wa, ba


def _leaky(z, slope):
    return torch.where(z > 0, z, z * slope)


def _softplus(x):
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def fused_decode_plain(feat, dists, extras, w, params: Dict,
                       spec: DecodeSpec):
    """Plain PyTorch version. feat [M, Fi], dists [M, Dd], extras [M, E],
    w [M, 1] (weight * conf, zero on masked rows). Returns (fagg [M/K, H],
    alpha [M/K, 1]), f32."""
    r = lambda t: _round(t.float(), spec.bf16)   # noqa: E731
    feat, dists, extras, w = r(feat), r(dists), r(extras), r(w)
    Ws, bs, wa, ba = prep_weights(params, spec)
    h = r(build_x(feat, dists, spec))
    for i in range(spec.L1 + spec.L3):
        if i == spec.L1:
            h = torch.cat([h, extras], -1)
        h = r(_leaky(h @ Ws[i] + bs[i], spec.neg_slope))
    za = (h * wa).sum(-1, keepdim=True) + ba
    alpha_pp = _softplus(za - 1.0)
    M = h.shape[0]
    G = M // spec.K
    fagg = (h * w).view(G, spec.K, spec.H).sum(1)
    alpha = (alpha_pp * w).view(G, spec.K).sum(1, keepdim=True)
    return fagg, alpha


def _lib():
    f = _build.load("fused_decode").fused_decode_launch
    if f.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, vp, vp,
                      ci, ci, ci, ci, ci, ci, ci, ci, ctypes.c_float, ci,
                      vp, vp, vp]
        f.restype = ci
    return f


def smem_bytes(spec: DecodeSpec) -> int:
    width = max(spec.x1, spec.H + spec.E) + 1
    return 2 * TILE_ROWS * width * 4


def kernel_takes(spec: DecodeSpec) -> bool:
    """True when csrc/fused_decode.cu can run this spec: whole K-groups per
    tile, H a multiple of 32 up to 256, at most MAX_LAYERS block layers, and
    two activation tiles inside the shared memory of one block."""
    return not (TILE_ROWS % spec.K or spec.H % 32 or spec.H > 256
                or spec.L1 + spec.L3 > MAX_LAYERS or spec.L1 < 1
                or spec.L3 < 1 or smem_bytes(spec) > SMEM_BYTES)


def _check(feat, dists, extras, w, spec: DecodeSpec):
    dev = feat.device
    M = feat.shape[0]
    for name, t, shape in (("feat", feat, (M, spec.Fi)),
                           ("dists", dists, (M, spec.Dd)),
                           ("extras", extras, (M, spec.E)),
                           ("w", w, (M, 1))):
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"fused_decode: {name} must be a contiguous float32 {shape} "
                f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if M % spec.K:
        raise ValueError(f"fused_decode: M={M} is not a multiple of K")


def fused_decode(feat, dists, extras, w, params: Dict, spec: DecodeSpec):
    """Weighted K-sums of the final shading feature and the per-point
    density (see module docstring). Launches the kernel for CUDA tensors."""
    _check(feat, dists, extras, w, spec)
    if feat.device.type == "cpu":
        return fused_decode_plain(feat, dists, extras, w, params, spec)
    if not kernel_takes(spec):
        raise ValueError(f"fused_decode: the CUDA kernel does not take "
                         f"{spec} (needs 64 % K == 0, H % 32 == 0, H <= 256, "
                         f"L1, L3 >= 1, L1 + L3 <= {MAX_LAYERS})")
    M = feat.shape[0]
    dev = feat.device
    Ws, bs, wa, ba = prep_weights(params, spec)
    for t in Ws + bs + [wa, ba]:
        if t.device != dev:
            raise ValueError("fused_decode: params must lie on the inputs' "
                             f"device {dev}")
    fagg = torch.empty((M // spec.K, spec.H), dtype=torch.float32,
                       device=dev)
    alpha = torch.empty((M // spec.K, 1), dtype=torch.float32, device=dev)
    p = _build.ptr
    n = spec.L1 + spec.L3
    wptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in Ws])
    bptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in bs])
    err = _lib()(p(feat), p(dists), p(extras), p(w),
                 ctypes.cast(wptrs, ctypes.c_void_p),
                 ctypes.cast(bptrs, ctypes.c_void_p), spec.L1, spec.L3,
                 p(wa), p(ba), M, spec.Fi, spec.Dd, spec.E, spec.Ff, spec.Fd,
                 spec.H, spec.K, float(spec.neg_slope), int(spec.bf16),
                 p(fagg), p(alpha), _build.stream_handle(dev))
    _build.check(err, "fused_decode")
    fused_decode.launches += 1
    return fagg, alpha


fused_decode.launches = 0


def flops(M: int, spec: DecodeSpec) -> int:
    """Multiply-adds x 2 of the decode's matrix products for M rows."""
    dims: List[int] = [spec.x1] + [spec.H] * (spec.L1 - 1) \
        + [spec.H + spec.E] + [spec.H] * (spec.L3 - 1)
    return 2 * M * (sum(d * spec.H for d in dims) + spec.H)
