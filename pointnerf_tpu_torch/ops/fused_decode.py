"""K3 and K4: the fused decode — PE -> block1 -> [h, extras] -> block3 ->
per-point alpha -> weighted K-reduction, per neighbor row — and its backward.

Replaces `pointnerf_tpu/ops/pallas_decode.py::fused_decode`: the forward
(`_fwd_impl` / `_fwd_kernel` / `_forward_tile` / `_build_x`) is K3,
`csrc/fused_decode.cu`; the custom-VJP backward (`_bwd_rule` /
`_bwd_kernel`) is K4, `csrc/fused_decode_bwd.cu`. `fused_decode` is a
`torch.autograd.Function` when a gradient is wanted: its forward launches K3
and its backward K4 for CUDA tensors; for CPU tensors they run
`fused_decode_plain` and `fused_decode_bwd_plain`.

x per row is laid out exactly as `models/aggregator.aggregate` builds it:
[feat | PE(feat) | PE(dists)] with the interleaved (sin, cos) per
(channel, freq) layout of `ops/pe.py`, so the first block1 weight is used as
the JAX parameters hold it (no row permutation), and its gradient comes out
in that layout too.

With `spec.bf16` the function rounds where the JAX kernel rounds: feat,
dists, extras and w to bf16 before anything else (`_pack_raw`), PE from the
rounded values, x and every hidden activation to bf16, the block weights to
bf16; products accumulate in f32, and the alpha head is f32 against an f32
weight. The backward also rounds every g_z to bf16 before its two products.
The weights enter as f32 tensors and their gradients come back in f32: the
bf16 cast is straight-through for dW, as in JAX where `_prep_weights` runs
inside the custom VJP. Both versions here round at the same places.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple

import torch

from . import _build
from .pe import positional_encoding

TILE_ROWS = 64          # rows per CTA in csrc/fused_decode.cu
TILE_ROWS_BWD = 32      # rows per tile in csrc/fused_decode_bwd.cu
MAX_LAYERS = 8          # L1 + L3 the kernels' parameter blocks hold
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


def fused_decode_bwd_plain(feat, dists, extras, w, params: Dict,
                           spec: DecodeSpec, g_fagg, g_alpha):
    """Plain PyTorch version of the backward, written out line for line
    after the JAX `_bwd_kernel` (autograd of `fused_decode_plain` would round
    the gradient at every bf16 cast, which JAX does not do). g_fagg [M/K, H],
    g_alpha [M/K, 1]. Returns (g_feat, g_dists, g_extras, g_w, g_params), f32,
    g_params in the layout of `params` (block1 / block3 / alpha)."""
    r = lambda t: _round(t.float(), spec.bf16)   # noqa: E731
    feat, dists, extras, w = r(feat), r(dists), r(extras), r(w)
    Ws, bs, wa, ba = prep_weights(params, spec)
    L, H, K = spec.L1 + spec.L3, spec.H, spec.K
    h = r(build_x(feat, dists, spec))
    acts, zs = [], []
    for i in range(L):
        if i == spec.L1:
            h = torch.cat([h, extras], -1)
        acts.append(h)
        zs.append(h @ Ws[i] + bs[i])
        h = r(_leaky(zs[-1], spec.neg_slope))
    g_f = g_fagg.float().repeat_interleave(K, 0)                  # [M, H]
    g_a = g_alpha.float().reshape(-1, 1).repeat_interleave(K, 0)  # [M, 1]
    za = (h * wa).sum(-1, keepdim=True) + ba
    g_w = (h * g_f).sum(-1, keepdim=True) + _softplus(za - 1.0) * g_a
    g_za = g_a * w * torch.sigmoid(za - 1.0)
    dwa, dba = (h * g_za).sum(0), g_za.sum(0)
    g_h = g_f * w + g_za * wa
    dWs, dbs = [None] * L, [None] * L
    g_extras = None
    for i in reversed(range(L)):
        g_z = g_h * torch.where(zs[i] > 0, 1.0, spec.neg_slope)
        dbs[i] = g_z.sum(0)
        g_zr = r(g_z)
        dWs[i] = acts[i].t() @ g_zr
        g_h = g_zr @ Ws[i].t()
        if i == spec.L1:
            g_extras = g_h[:, H:]
            g_h = g_h[:, :H]
    # PE backward in the interleaved layout: g_x = [feat | PE(feat) | PE(d)]
    Fi, Dd, Ff, Fd = spec.Fi, spec.Dd, spec.Ff, spec.Fd
    g_feat = g_h[:, :Fi]
    pe = g_h[:, Fi:Fi + 2 * Ff * Fi].reshape(-1, Fi, Ff, 2)
    for f in range(Ff):
        b = feat * (2.0 ** f)
        g_feat = g_feat + (2.0 ** f) * (pe[..., f, 0] * torch.cos(b)
                                        - pe[..., f, 1] * torch.sin(b))
    off = Fi + 2 * Ff * Fi
    if Fd > 0:
        pd = g_h[:, off:off + 2 * Fd * Dd].reshape(-1, Dd, Fd, 2)
        g_dists = torch.zeros_like(dists)
        for f in range(Fd):
            b = dists * (2.0 ** f)
            g_dists = g_dists + (2.0 ** f) * (pd[..., f, 0] * torch.cos(b)
                                              - pd[..., f, 1] * torch.sin(b))
    else:
        g_dists = g_h[:, off:off + Dd]
    g_params = _unflatten([t for i in range(L) for t in (dWs[i], dbs[i])]
                          + [dwa.reshape(H, 1), dba.reshape(1)], spec)
    return (g_feat.contiguous(), g_dists.contiguous(), g_extras.contiguous(),
            g_w, g_params)


def _flatten(params: Dict) -> List[torch.Tensor]:
    """[block1 w, b, ..., block3 w, b, ..., alpha w, alpha b]."""
    return [layer[n] for name in ("block1", "block3", "alpha")
            for layer in params[name] for n in ("w", "b")]


def _unflatten(flat: List[torch.Tensor], spec: DecodeSpec) -> Dict:
    layers = [{"w": flat[2 * i], "b": flat[2 * i + 1]}
              for i in range(len(flat) // 2)]
    return {"block1": layers[:spec.L1],
            "block3": layers[spec.L1:spec.L1 + spec.L3],
            "alpha": layers[spec.L1 + spec.L3:]}


def _argtypes(f, types):
    if f.argtypes is None:
        f.argtypes = types
        f.restype = ctypes.c_int
    return f


_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    return _argtypes(_build.load("fused_decode").fused_decode_launch,
                     [_VP] * 6 + [_CI, _CI, _VP, _VP] + [_CI] * 8
                     + [_CF, _CI, _VP, _VP, _VP])


def smem_bytes(spec: DecodeSpec) -> int:
    width = max(spec.x1, spec.H + spec.E) + 1
    return 2 * TILE_ROWS * width * 4


def layer_inputs(spec: DecodeSpec) -> List[int]:
    """Input width of each block layer: x1, H, ..., H + E, H, ..."""
    return [spec.x1] + [spec.H] * (spec.L1 - 1) + [spec.H + spec.E] \
        + [spec.H] * (spec.L3 - 1)


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def bwd_smem_bytes(spec: DecodeSpec) -> int:
    """Shared memory of one K4 tile (`smem_bytes` in fused_decode_bwd.cu):
    every layer's input (widths padded to a multiple of 4), the last hidden
    layer, the input-gradient buffer, the z-sign bitmasks and two per-row
    scalars, for TILE_ROWS_BWD rows."""
    ins = [_pad4(n) for n in layer_inputs(spec)]
    return 4 * (TILE_ROWS_BWD * (sum(ins) + spec.H + max(ins))
                + len(ins) * TILE_ROWS_BWD * (spec.H // 32)
                + 2 * TILE_ROWS_BWD)


def kernel_takes(spec: DecodeSpec, backward: bool = False) -> bool:
    """True when csrc/fused_decode.cu can run this spec (and, with
    `backward`, csrc/fused_decode_bwd.cu too): whole K-groups per forward
    tile, H a multiple of 32 up to 256, 1 to MAX_LAYERS block layers, and
    the tiles inside the shared memory of one block."""
    fwd = not (TILE_ROWS % spec.K or spec.H % 32 or spec.H > 256
               or spec.L1 + spec.L3 > MAX_LAYERS or spec.L1 < 1
               or spec.L3 < 1 or smem_bytes(spec) > SMEM_BYTES)
    return fwd and (not backward or bwd_smem_bytes(spec) <= SMEM_BYTES)


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


def _refuse(spec: DecodeSpec, backward: bool):
    if not kernel_takes(spec, backward):
        raise ValueError(
            f"fused_decode: the CUDA kernel{'s do' if backward else ' does'} "
            f"not take {spec} (needs 64 % K == 0, H % 32 == 0, H <= 256, "
            f"L1, L3 >= 1, L1 + L3 <= {MAX_LAYERS}, tiles within "
            f"{SMEM_BYTES} bytes of shared memory)")


def _device_weights(params: Dict, spec: DecodeSpec, dev):
    Ws, bs, wa, ba = prep_weights(params, spec)
    for t in Ws + bs + [wa, ba]:
        if t.device != dev:
            raise ValueError("fused_decode: params must lie on the inputs' "
                             f"device {dev}")
    return Ws, bs, wa, ba


def _ptrs(ts):
    arr = (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    return ctypes.cast(arr, ctypes.c_void_p), arr


def _forward(feat, dists, extras, w, params: Dict, spec: DecodeSpec):
    """K3 for CUDA tensors, the plain version for CPU tensors."""
    if feat.device.type == "cpu":
        return fused_decode_plain(feat, dists, extras, w, params, spec)
    _refuse(spec, backward=False)
    M = feat.shape[0]
    dev = feat.device
    Ws, bs, wa, ba = _device_weights(params, spec, dev)
    fagg = torch.empty((M // spec.K, spec.H), dtype=torch.float32,
                       device=dev)
    alpha = torch.empty((M // spec.K, 1), dtype=torch.float32, device=dev)
    p = _build.ptr
    wp, _keep_w = _ptrs(Ws)
    bp, _keep_b = _ptrs(bs)
    err = _lib()(p(feat), p(dists), p(extras), p(w), wp, bp, spec.L1,
                 spec.L3, p(wa), p(ba), M, spec.Fi, spec.Dd, spec.E, spec.Ff,
                 spec.Fd, spec.H, spec.K, float(spec.neg_slope),
                 int(spec.bf16), p(fagg), p(alpha),
                 _build.stream_handle(dev))
    _build.check(err, "fused_decode")
    fused_decode.launches += 1
    return fagg, alpha


class _FusedDecode(torch.autograd.Function):
    """fused_decode with K4 as its backward; the weights enter flat
    (`_flatten`) so that each gets its own f32 gradient."""

    @staticmethod
    def forward(ctx, feat, dists, extras, w, spec, *flat):
        ctx.spec = spec
        ctx.save_for_backward(feat, dists, extras, w, *flat)
        return _forward(feat, dists, extras, w, _unflatten(list(flat), spec),
                        spec)

    @staticmethod
    def backward(ctx, g_fagg, g_alpha):
        spec = ctx.spec
        feat, dists, extras, w, *flat = ctx.saved_tensors
        G = feat.shape[0] // spec.K
        if g_fagg is None:
            g_fagg = feat.new_zeros((G, spec.H))
        if g_alpha is None:
            g_alpha = feat.new_zeros((G, 1))
        g_feat, g_dists, g_extras, g_w, g_params = fused_decode_bwd(
            feat, dists, extras, w, _unflatten(flat, spec), spec,
            g_fagg.float().contiguous(), g_alpha.float().contiguous())
        return (g_feat, g_dists, g_extras, g_w, None, *_flatten(g_params))


def fused_decode(feat, dists, extras, w, params: Dict, spec: DecodeSpec):
    """Weighted K-sums of the final shading feature and the per-point
    density (see module docstring). feat [M, Fi], dists [M, Dd],
    extras [M, E], w [M, 1] (weight * conf, zero on masked rows). Returns
    (fagg [M/K, H], alpha [M/K, 1]), f32. Launches K3 for CUDA tensors;
    under autograd its backward is `fused_decode_bwd` (K4)."""
    _check(feat, dists, extras, w, spec)
    flat = _flatten(params)
    if not torch.is_grad_enabled() or not any(
            t.requires_grad for t in [feat, dists, extras, w] + flat):
        return _forward(feat, dists, extras, w, params, spec)
    return _FusedDecode.apply(feat, dists, extras, w, spec, *flat)


fused_decode.launches = 0


def _bwd_lib(name):
    f = getattr(_build.load("fused_decode_bwd"), name)
    if name == "fused_decode_bwd_blocks":
        return _argtypes(f, [_CI] * 10 + [ctypes.POINTER(_CI)])
    return _argtypes(f, [_VP] * 7 + [_CI, _CI] + [_VP] * 4 + [_CI] * 8
                     + [_CF, _CI] + [_VP] * 5 + [_CI, _VP, _VP])


def param_count(spec: DecodeSpec) -> int:
    """Floats of all dW, db, dwa, dba together (K4's workspace slice)."""
    return sum(n * spec.H + spec.H for n in layer_inputs(spec)) + spec.H + 1


def fused_decode_bwd(feat, dists, extras, w, params: Dict, spec: DecodeSpec,
                     g_fagg, g_alpha):
    """Gradients of `fused_decode` (see `fused_decode_bwd_plain`). Launches
    K4 for CUDA tensors; runs the plain version for CPU tensors."""
    _check(feat, dists, extras, w, spec)
    G = feat.shape[0] // spec.K
    for name, t, shape in (("g_fagg", g_fagg, (G, spec.H)),
                           ("g_alpha", g_alpha, (G, 1))):
        if t.device != feat.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"fused_decode_bwd: {name} must be a contiguous "
                             f"float32 {shape} tensor on {feat.device}")
    if feat.device.type == "cpu":
        return fused_decode_bwd_plain(feat, dists, extras, w, params, spec,
                                      g_fagg, g_alpha)
    _refuse(spec, backward=True)
    M = feat.shape[0]
    dev = feat.device
    Ws, bs, wa, ba = _device_weights(params, spec, dev)
    # input rows zero-padded to a multiple of 4, as the kernel reads them
    Ws = [torch.nn.functional.pad(t, (0, 0, 0, _pad4(t.shape[0]) - t.shape[0]))
          for t in Ws]
    WTs = [t.t().contiguous() for t in Ws]
    # the kernel reads the biases as float4
    bs = [t if t.data_ptr() % 16 == 0 else t.clone() for t in bs]
    dims = (M, spec.Fi, spec.Dd, spec.E, spec.Ff, spec.Fd, spec.H, spec.K,
            spec.L1, spec.L3)
    nb = ctypes.c_int(0)
    _build.check(_bwd_lib("fused_decode_bwd_blocks")(*dims, ctypes.byref(nb)),
                 "fused_decode_bwd")
    P = param_count(spec)
    # one slice per CTA, each starting 16-byte aligned for float4 access
    partials = torch.empty((max(nb.value, 1), _pad4(P)), dtype=torch.float32,
                           device=dev)
    dparams = torch.empty(P, dtype=torch.float32, device=dev)
    g_feat = torch.empty_like(feat)
    g_dists = torch.empty_like(dists)
    g_extras = torch.empty_like(extras)
    g_w = torch.empty_like(w)
    p = _build.ptr
    wp, _kw = _ptrs(Ws)
    wtp, _kwt = _ptrs(WTs)
    bp, _kb = _ptrs(bs)
    err = _bwd_lib("fused_decode_bwd_launch")(
        p(feat), p(dists), p(extras), p(w), wp, wtp, bp, spec.L1, spec.L3,
        p(wa), p(ba), p(g_fagg), p(g_alpha), *dims[:8], float(spec.neg_slope),
        int(spec.bf16), p(g_feat), p(g_dists), p(g_extras), p(g_w),
        p(partials), nb.value, p(dparams), _build.stream_handle(dev))
    _build.check(err, "fused_decode_bwd")
    fused_decode_bwd.launches += 1
    flat, off = [], 0
    for t in _flatten(params):
        flat.append(dparams[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return g_feat, g_dists, g_extras, g_w, _unflatten(flat, spec)


fused_decode_bwd.launches = 0


def flops(M: int, spec: DecodeSpec) -> int:
    """Multiply-adds x 2 of the decode's matrix products for M rows."""
    return 2 * M * (sum(d * spec.H for d in layer_inputs(spec)) + spec.H)
