"""K3 and K4: the fused decode — PE -> block1 -> [h, extras] -> block3 ->
per-point alpha -> weighted K-reduction, per neighbor row — and its backward.

Replaces `pointnerf_tpu/ops/pallas_decode.py::fused_decode`: the forward
(`_fwd_impl` / `_fwd_kernel` / `_forward_tile` / `_build_x`) is K3, the
custom-VJP backward (`_bwd_rule` / `_bwd_kernel`) is K4, each a CUDA kernel
on one of two routes (below). `fused_decode` is a
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

Three routes on the card, picked from the spec (`route`), never on an
error. bf16 (the main paths) runs the tensor-core kernels
`csrc/fused_decode_tc.cu` (K3) and `csrc/fused_decode_bwd_tc.cu` (K4),
which take the block weights packed by `pack_tc_weights` and skip tiles
without weight. f32 runs `csrc/fused_decode.cu` and
`csrc/fused_decode_bwd.cu` on the CUDA cores (exact f32 FMAs; tensor cores
would add a TF32 rounding point), with the block weights packed by
`pack_f32_weights`. Both f32 kernels first build, on the device, the list
of live shading groups (`csrc/decode_live.cuh`; `live_groups_plain` is its
plain version) and decode only those: the dense decode of a scene lays its
rows out [R, SR, K], and ~1% of them carry a weight, scattered over every
ray. K4 f32 takes dW as a split-K product over scratch rows written by its
first phase, in batches of F32_CAP_ROWS live rows. A spec past those tuned
kernels' limits (`kernel_takes`: H, depth, K, layer widths) takes the
general kernels `csrc/fused_decode_any.cu` (K3) and
`csrc/fused_decode_bwd_any.cu` (K4), in either rounding: any widths, any
depth and any K. They decode the live groups of the same list, bf16 on the
tensor cores and f32 on the CUDA cores, every width padded with zero
weights to the product's granularity, a tile of T rows (64, 32 or 16)
whose state fits shared memory (`general_plan`; `csrc/decode_any.cuh`),
the weights as `pack_any_weights` lays them out; K4 takes dW as a split-K
product over scratch rows, in batches of GENERAL_CAP_ROWS. Each wrapper
counts its launches per route in `launches_by_route`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Tuple

import torch

from . import _build
from .pe import positional_encoding

MAX_LAYERS = 8          # L1 + L3 the kernels' parameter blocks hold
SMEM_BYTES = 232448     # per-block shared memory the H100 grants
# the f32 kernels (csrc/decode_f32.cuh, decode_live.cuh and their two users)
F32_ROWS = 64           # rows per tile (whole K-groups in K3)
F32_LDS = F32_ROWS + 4  # row stride of the transposed tiles in shared memory
F32_PAD = 16            # forward weight rows (layer inputs) pad to it
F32_RING = (16, 2)      # K3's weight ring: rows per chunk, stages
F32_RING_BWD = (8, 3)   # K4 phase A's
F32_BN = 256            # columns of a ring stage
F32_KB = 32             # K4 phase B: scratch rows per staged chunk
F32_BI = 64             # K4 phase B: dW rows per CTA
F32_SPLITS = 16         # K4 phase B: row splits of dW, summed in order
F32_CAP_ROWS = 131072   # K4: live rows per batch of the scratch
LIVE_GROUPS = 1024      # groups per block of the live-list pass
# the tensor-core kernels (csrc/decode_tc.cuh and its two users)
TC_ROWS = 64            # rows per CTA of K3 (fused_decode_tc.cu)
TC_ROWS_BWD = 64        # rows per tile of K4's phase A (fused_decode_bwd_tc.cu)
TC_KC = 32              # weight rows per streamed chunk; layer inputs pad to it
TC_STAGES = 3           # depth of the weight ring
TC_MAX_IN = 320         # widest padded layer input
TC_PAD = 8              # bf16 row padding in shared memory
TC_BN = 64              # K4 phase B: dW columns per CTA
TC_SPLITS = 16          # K4 phase B: row splits of dW, summed in order
# the general kernels (csrc/decode_any.cuh and its two users)
GENERAL_TILES = (64, 32, 16)  # rows per tile: the largest whose state fits
GENERAL_BLOCK = 256     # tensor cores: output columns per block
GENERAL_CC_RING = (8, 3)  # CUDA cores: weight rows per chunk, stages
GENERAL_CC_ROWS = 16384  # CUDA cores: T x the columns of one pass
GENERAL_CAP_ROWS = 131072  # K4: live rows per batch of the scratch
GENERAL_SPLITS = 16     # K4 phase B: row splits of dW, summed in order


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


def _weights_as(params: Dict, spec: DecodeSpec, dtype):
    Ws, bs, wa, ba = prep_weights(params, spec)
    return ([t.to(dtype) for t in Ws], [t.to(dtype) for t in bs],
            wa.to(dtype), ba.to(dtype))


def fused_decode_plain(feat, dists, extras, w, params: Dict,
                       spec: DecodeSpec, dtype=torch.float32):
    """Plain PyTorch version. feat [M, Fi], dists [M, Dd], extras [M, E],
    w [M, 1] (weight * conf, zero on masked rows). Returns (fagg [M/K, H],
    alpha [M/K, 1]), f32. `dtype` is the type its products and sums run in:
    float32, or float64 for a reference whose sums do not depend on their
    order (the rounding points stay where they are)."""
    r = lambda t: _round(t.float(), spec.bf16).to(dtype)   # noqa: E731
    feat, dists, extras, w = r(feat), r(dists), r(extras), r(w)
    Ws, bs, wa, ba = _weights_as(params, spec, dtype)
    h = r(build_x(feat.float(), dists.float(), spec))
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
    return fagg.float(), alpha.float()


def fused_decode_bwd_plain(feat, dists, extras, w, params: Dict,
                           spec: DecodeSpec, g_fagg, g_alpha,
                           dtype=torch.float32, masks=None):
    """Plain PyTorch version of the backward, written out line for line
    after the JAX `_bwd_kernel` (autograd of `fused_decode_plain` would round
    the gradient at every bf16 cast, which JAX does not do). g_fagg [M/K, H],
    g_alpha [M/K, 1]. Returns (g_feat, g_dists, g_extras, g_w, g_params), f32,
    g_params in the layout of `params` (block1 / block3 / alpha). `dtype`
    as for `fused_decode_plain`. `masks`, each layer's leaky-ReLU branches
    [M, H] (z > 0) to take in place of its own: another side's, so that a
    pre-activation summed across 0 there moves nothing but its rounding."""
    r = lambda t: _round(t.float(), spec.bf16).to(dtype)   # noqa: E731
    feat, dists, extras, w = r(feat), r(dists), r(extras), r(w)
    Ws, bs, wa, ba = _weights_as(params, spec, dtype)
    L, H, K = spec.L1 + spec.L3, spec.H, spec.K
    h = r(build_x(feat.float(), dists.float(), spec))
    acts, zs = [], []
    for i in range(L):
        if i == spec.L1:
            h = torch.cat([h, extras], -1)
        acts.append(h)
        zs.append(h @ Ws[i] + bs[i])
        pos = zs[-1] > 0 if masks is None else masks[i]
        h = r(torch.where(pos, zs[-1], zs[-1] * spec.neg_slope))
    g_f = g_fagg.to(dtype).repeat_interleave(K, 0)                  # [M, H]
    g_a = g_alpha.to(dtype).reshape(-1, 1).repeat_interleave(K, 0)  # [M, 1]
    za = (h * wa).sum(-1, keepdim=True) + ba
    g_w = (h * g_f).sum(-1, keepdim=True) + _softplus(za - 1.0) * g_a
    g_za = g_a * w * torch.sigmoid(za - 1.0)
    dwa, dba = (h * g_za).sum(0), g_za.sum(0)
    g_h = g_f * w + g_za * wa
    dWs, dbs = [None] * L, [None] * L
    g_extras = None
    for i in reversed(range(L)):
        pos = zs[i] > 0 if masks is None else masks[i]
        g_z = g_h * torch.where(pos, 1.0, spec.neg_slope)
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
    if Ff > 0:
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
    g_params = _unflatten([t.float() for i in range(L)
                           for t in (dWs[i], dbs[i])]
                          + [dwa.reshape(H, 1).float(),
                             dba.reshape(1).float()], spec)
    return (g_feat.float().contiguous(), g_dists.float().contiguous(),
            g_extras.float().contiguous(), g_w.float(), g_params)


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


_F32_ARGS = {
    "fused_decode_launch": [_VP] * 8 + [_CI] * 10 + [_CF] + [_VP] * 7,
    "fused_decode_live": [_VP] * 3 + [_CI] * 3 + [_VP] * 5,
    "fused_decode_smem": [_CI] * 9,
    "fused_decode_bwd_launch": [_VP] * 10 + [_CI] * 10 + [_CF] + [_VP] * 10
    + [_CI] + [_VP] * 2 + [_CI] + [_VP] * 2,
    "fused_decode_bwd_smem": [_CI] * 9 + [ctypes.POINTER(_CI)] * 2,
}


def _f32_lib(name: str):
    lib = "fused_decode_bwd" if name.startswith("fused_decode_bwd") \
        else "fused_decode"
    return _argtypes(getattr(_build.load(lib), name), _F32_ARGS[name])


def layer_inputs(spec: DecodeSpec) -> List[int]:
    """Input width of each block layer: x1, H, ..., H + E, H, ..."""
    return [spec.x1] + [spec.H] * (spec.L1 - 1) + [spec.H + spec.E] \
        + [spec.H] * (spec.L3 - 1)


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def f32_pads(spec: DecodeSpec) -> Tuple[List[int], List[int]]:
    """Each layer's input width padded to F32_PAD (`kp`: the rows of the
    forward weight stream and of the products) and to 4 (`kq`: the columns
    of W^T and the scratch row of K4), as `make_dims` in
    csrc/decode_f32.cuh."""
    ins = layer_inputs(spec)
    return ([-(-n // F32_PAD) * F32_PAD for n in ins],
            [_pad4(n) for n in ins])


def smem_bytes(spec: DecodeSpec) -> int:
    """Shared memory of one K3 f32 CTA (`smem_bytes` in fused_decode.cu): the
    tile's transposed activations, the weight ring and three per-row
    words."""
    kmax = max(f32_pads(spec)[0])
    return 4 * (kmax * F32_LDS + F32_RING[0] * F32_RING[1] * F32_BN
                + 3 * F32_ROWS)


def bwd_smem_bytes(spec: DecodeSpec) -> Tuple[int, int]:
    """Shared memory of one CTA of K4 f32's phase A and of its phase B
    (`smem_a` and `smem_b` in fused_decode_bwd.cu). Phase A: the transposed
    activations (then g_h), a layer's g_z, the z-sign bits of every layer,
    the weight ring and three per-row words. Phase B: two stages of 32
    scratch rows of 64 layer inputs and of 256 g_z columns."""
    kmax = max(f32_pads(spec)[0])
    L = spec.L1 + spec.L3
    a = 4 * ((kmax + spec.H) * F32_LDS + L * F32_ROWS * (spec.H // 32)
             + F32_RING_BWD[0] * F32_RING_BWD[1] * F32_BN + 3 * F32_ROWS)
    b = 4 * 2 * F32_KB * (F32_BI + F32_BN)
    return a, b


def pack_f32_weights(Ws: List[torch.Tensor], spec: DecodeSpec,
                     backward: bool = False) -> torch.Tensor:
    """The block weights as the f32 kernels stream them, one f32 buffer: the
    forward stream (each W_l [in_l, H] zero-padded to [kp_l, H], layer after
    layer), then with `backward` the backward stream (each W_l^T as
    [H, kq_l], zero columns past in_l)."""
    kp, kq = f32_pads(spec)
    fwd = [torch.nn.functional.pad(W, (0, 0, 0, p - W.shape[0])).reshape(-1)
           for W, p in zip(Ws, kp)]
    bwd = [torch.nn.functional.pad(W.t(), (0, q - W.shape[0])).reshape(-1)
           for W, q in zip(Ws, kq)] if backward else []
    return torch.cat(fwd + bwd).contiguous()


def tc_pads(spec: DecodeSpec) -> List[int]:
    """Each layer's input width padded to a multiple of TC_KC (`kp` of
    csrc/decode_tc.cuh)."""
    return [-(-n // TC_KC) * TC_KC for n in layer_inputs(spec)]


def tc_smem_bytes(spec: DecodeSpec) -> int:
    """Shared memory of one K3 tensor-core CTA (`smem_bytes` in
    fused_decode_tc.cu): the tile's bf16 activations, the weight ring and two
    per-row floats."""
    kmax = max(tc_pads(spec))
    return (2 * (TC_ROWS * (kmax + TC_PAD)
                 + TC_STAGES * TC_KC * (spec.H + TC_PAD))
            + 4 * 2 * TC_ROWS)


def tc_bwd_smem_bytes(spec: DecodeSpec) -> Tuple[int, int]:
    """Shared memory of one CTA of K4's phase A and of its phase B
    (`shape_a` and `smem_b` in fused_decode_bwd_tc.cu). Phase A: bf16
    activations sharing their bytes with the f32 input gradients, the bf16
    g_zr, the z-sign bits, the weight ring (a forward chunk or a W^T block,
    whichever is larger) and two per-row floats. Phase B: two stages of a
    tile's layer input and a 64-column slice of its g_zr."""
    H, R = spec.H, TC_ROWS_BWD
    kmax = max(tc_pads(spec))
    u = max(2 * R * (kmax + TC_PAD), 4 * R * (kmax + 4))
    ring_at = u + 2 * R * (H + TC_PAD) + 4 * (spec.L1 + spec.L3) * R * (H // 32)
    ring_at = -(-ring_at // 16) * 16
    stage = max(TC_KC * (H + TC_PAD), kmax * (TC_KC + TC_PAD))
    a = ring_at + 2 * TC_STAGES * stage + 4 * 2 * R
    b = 2 * 2 * R * ((kmax + TC_PAD) + (TC_BN + TC_PAD))
    return a, b


def pack_tc_weights(Ws: List[torch.Tensor], spec: DecodeSpec) -> torch.Tensor:
    """The block weights as the tensor-core kernels stream them, one bf16
    buffer: the forward stream (each W_l [in_l, H] zero-padded to
    [kp_l, H], layer after layer), then the backward stream (per layer, the
    column blocks W_l[:, 32j:32j+32] as contiguous [kp_l, 32] blocks)."""
    padded = [torch.nn.functional.pad(W.to(torch.bfloat16),
                                      (0, 0, 0, kp - W.shape[0]))
              for W, kp in zip(Ws, tc_pads(spec))]
    fwd = [p.reshape(-1) for p in padded]
    bwd = [p.view(p.shape[0], spec.H // TC_KC, TC_KC).permute(1, 0, 2)
           .reshape(-1) for p in padded]
    return torch.cat(fwd + bwd)


def kernel_takes(spec: DecodeSpec, backward: bool = False) -> bool:
    """True when the tuned kernels of this spec's rounding take it, the
    forward (and, with `backward`, the backward too); elsewhere the general
    kernels run it (`route`). Both tuned routes: H a multiple of 32 from 32
    to 256, 1 to MAX_LAYERS block layers, whole K-groups per 64-row tile
    (64 % K == 0). f32 (csrc/fused_decode.cu, fused_decode_bwd.cu): each
    kernel's shared memory within one block's. bf16 (the tensor-core
    kernels): every padded layer input at most TC_MAX_IN, and each
    kernel's shared memory within one block's."""
    common = not (spec.H % 32 or spec.H < 32 or spec.H > 256 or spec.L1 < 1
                  or spec.L3 < 1 or spec.L1 + spec.L3 > MAX_LAYERS
                  or F32_ROWS % spec.K)
    if not common:
        return False
    if spec.bf16:
        if max(tc_pads(spec)) > TC_MAX_IN \
                or tc_smem_bytes(spec) > SMEM_BYTES:
            return False
        return not backward or max(tc_bwd_smem_bytes(spec)) <= SMEM_BYTES
    fwd = smem_bytes(spec) <= SMEM_BYTES
    return fwd and (not backward or max(bwd_smem_bytes(spec)) <= SMEM_BYTES)


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


def _device_weights(params: Dict, spec: DecodeSpec, dev):
    Ws, bs, wa, ba = prep_weights(params, spec)
    for t in Ws + bs + [wa, ba]:
        if t.device != dev:
            raise ValueError("fused_decode: params must lie on the inputs' "
                             f"device {dev}")
    return Ws, bs, wa, ba


def _live_scratch(G: int, dev):
    """The live-group list's buffers: flags (a byte per group), the live
    count of each block of the list pass, the list and its length."""
    return (torch.empty(max(G, 1), dtype=torch.uint8, device=dev),
            torch.empty(max(-(-G // LIVE_GROUPS), 1), dtype=torch.int32,
                        device=dev),
            torch.empty(max(G, 1), dtype=torch.int32, device=dev),
            torch.empty(1, dtype=torch.int32, device=dev))


def live_groups_plain(w, K: int, g_fagg=None, g_alpha=None) -> torch.Tensor:
    """Plain version of the f32 kernels' live-group list: the ascending ids
    of the groups (rows g*K .. g*K + K - 1 of w [M, 1]) with a nonzero
    weight (K3's rule), or, given the upstream gradients g_fagg [M/K, H]
    and g_alpha [M/K, 1], also those with a nonzero upstream gradient
    (K4's rule). int32."""
    live = (w.reshape(-1, K) != 0).any(1)
    if g_fagg is not None:
        live = live | (g_fagg != 0).any(1) | (g_alpha.reshape(-1) != 0)
    return torch.nonzero(live).reshape(-1).to(torch.int32)


def live_groups(w, K: int, g_fagg=None, g_alpha=None) -> torch.Tensor:
    """The live-group list as K3 and K4 build it (see `live_groups_plain`):
    for CUDA tensors the list pass of csrc/decode_live.cuh alone, then a
    read of its length (a host synchronisation: this is a check of the
    pass, which the decode kernels run inside their own launch); the plain
    version for CPU tensors."""
    if w.device.type == "cpu":
        return live_groups_plain(w, K, g_fagg, g_alpha)
    G = w.shape[0] // K
    H = 0 if g_fagg is None else g_fagg.shape[1]
    flags, counts, lst, count = _live_scratch(G, w.device)
    p = _build.ptr
    none = ctypes.c_void_p(0)
    err = _f32_lib("fused_decode_live")(
        p(w), none if g_fagg is None else p(g_fagg),
        none if g_alpha is None else p(g_alpha), G, K, H, p(flags),
        p(counts), p(lst), p(count), _build.stream_handle(w.device))
    _build.check(err, "fused_decode (live list)")
    return lst[:int(count.item())]


def _forward(feat, dists, extras, w, params: Dict, spec: DecodeSpec):
    """K3 for CUDA tensors, the plain version for CPU tensors."""
    if feat.device.type == "cpu":
        return fused_decode_plain(feat, dists, extras, w, params, spec)
    M = feat.shape[0]
    dev = feat.device
    Ws, bs, wa, ba = _device_weights(params, spec, dev)
    fagg = torch.empty((M // spec.K, spec.H), dtype=torch.float32,
                       device=dev)
    alpha = torch.empty((M // spec.K, 1), dtype=torch.float32, device=dev)
    p = _build.ptr
    r = route(spec)
    if r == "general":
        pl = any_plan(spec, M)
        ws = torch.empty(max(pl.grid * pl.ws, 1), dtype=torch.float32,
                         device=dev)
        Wp, bias = pack_any_weights(Ws, spec, pl), pack_any_bias(bs, spec, pl)
        live = _live_scratch(M // spec.K, dev)
        err = _any_lib("fused_decode_any_launch")(
            p(feat), p(dists), p(extras), p(w), p(Wp), p(bias), p(wa), p(ba),
            M, *_dims(spec), float(spec.neg_slope), int(spec.bf16),
            pl.grid, *[p(t) for t in live], p(ws), p(fagg), p(alpha),
            _build.stream_handle(dev))
        _build.check(err, "fused_decode (general)")
    elif spec.bf16:
        Wt, bias = pack_tc_weights(Ws, spec), torch.cat(bs)
        err = _tc_lib("fused_decode_tc_launch")(
            p(feat), p(dists), p(extras), p(w), p(Wt), p(bias), p(wa), p(ba),
            M, *_dims(spec), float(spec.neg_slope), p(fagg), p(alpha),
            _build.stream_handle(dev))
        _build.check(err, "fused_decode (tensor cores)")
    else:
        Wp, bias = pack_f32_weights(Ws, spec), torch.cat(bs)
        live = _live_scratch(M // spec.K, dev)
        err = _f32_lib("fused_decode_launch")(
            p(feat), p(dists), p(extras), p(w), p(Wp), p(bias), p(wa), p(ba),
            M, *_dims(spec), float(spec.neg_slope), *[p(t) for t in live],
            p(fagg), p(alpha), _build.stream_handle(dev))
        _build.check(err, "fused_decode")
    _count(fused_decode, r)
    return fagg, alpha


def _dims(spec: DecodeSpec):
    return (spec.Fi, spec.Dd, spec.E, spec.Ff, spec.Fd, spec.H, spec.K,
            spec.L1, spec.L3)


def _count(wrapper, route_name: str):
    """One launch of `wrapper`'s kernel, on `route_name`."""
    wrapper.launches += 1
    wrapper.launches_by_route[route_name] += 1


ROUTES = ("tensor_core", "cuda_core", "general")


def route(spec: DecodeSpec, backward: bool = False) -> str:
    """The kernel family a CUDA call with this spec runs: the tuned kernels
    of its rounding (the tensor cores for bf16, the CUDA cores for f32)
    where they take it (`kernel_takes`; with `backward`, K4's route),
    else the general kernels."""
    if not kernel_takes(spec, backward):
        return "general"
    return "tensor_core" if spec.bf16 else "cuda_core"


def reset_launches():
    """Set every decode launch count (both wrappers, every route) to 0."""
    for f in (fused_decode, fused_decode_bwd):
        f.launches = 0
        f.launches_by_route = dict.fromkeys(ROUTES, 0)


_TC_ARGS = {
    "fused_decode_tc_launch": [_VP] * 8 + [ctypes.c_int] * 10
    + [ctypes.c_float] + [_VP] * 3,
    "fused_decode_tc_smem": [ctypes.c_int] * 9,
    "fused_decode_bwd_tc_launch": [_VP] * 10 + [ctypes.c_int] * 10
    + [ctypes.c_float] + [_VP] * 9 + [ctypes.c_int] + [_VP] * 2,
    "fused_decode_bwd_tc_smem": [ctypes.c_int] * 9
    + [ctypes.POINTER(ctypes.c_int)] * 2,
}


def _tc_lib(name: str):
    lib = "fused_decode_tc" if name.startswith("fused_decode_tc") \
        else "fused_decode_bwd_tc"
    return _argtypes(getattr(_build.load(lib), name), _TC_ARGS[name])


def tc_smem_bytes_built(spec: DecodeSpec) -> Tuple[int, int, int]:
    """(K3, K4 phase A, K4 phase B) shared memory as the built kernels
    compute it (0 where they refuse the spec): the card's check of
    `tc_smem_bytes` and `tc_bwd_smem_bytes`."""
    a, b = ctypes.c_int(0), ctypes.c_int(0)
    k3 = _tc_lib("fused_decode_tc_smem")(*_dims(spec))
    _tc_lib("fused_decode_bwd_tc_smem")(*_dims(spec), ctypes.byref(a),
                                         ctypes.byref(b))
    return k3, a.value, b.value


def f32_smem_bytes_built(spec: DecodeSpec) -> Tuple[int, int, int]:
    """(K3, K4 phase A, K4 phase B) shared memory of the f32 kernels as the
    built kernels compute it (0 where they refuse the spec): the card's
    check of `smem_bytes` and `bwd_smem_bytes`."""
    a, b = ctypes.c_int(0), ctypes.c_int(0)
    k3 = _f32_lib("fused_decode_smem")(*_dims(spec))
    _f32_lib("fused_decode_bwd_smem")(*_dims(spec), ctypes.byref(a),
                                      ctypes.byref(b))
    return k3, a.value, b.value


class GeneralPlan(NamedTuple):
    """The general kernels' plan of a spec (`general_plan`), and with the
    launch's fields the built kernels' (`any_plan`)."""
    kind: str        # "tensor_cores" (bf16) or "cuda_cores"
    T: int           # rows per tile
    gpt: int         # K3: groups per item (T // K), or 1 when K > T
    slabs: int       # K3: slabs of T rows per item: 1, or ceil(K / T)
    smem: int        # shared memory bytes of K3, or of K4's phase A
    ws: int          # workspace floats per CTA (0: the tile lies in shared)
    Hp: int          # H padded
    kp0: int         # layer 0's input (x1) padded
    kpE: int         # layer L1's input (H + E) padded
    grid: int = 0       # any_plan: CTAs of K3, or of K4's phase A
    smem_b: int = 0     # any_plan, K4: phase B's dynamic shared memory bytes
    dw_blocks: int = 0  # any_plan, K4: phase B's CTAs along y
    cap: int = 0        # any_plan, K4: scratch rows a batch


def _rup(n: int, m: int) -> int:
    return -(-n // m) * m


def general_smem(spec: DecodeSpec, kind: str, T: int, backward: bool,
                 ws: bool = False) -> Tuple[int, int]:
    """(shared memory bytes, workspace floats per CTA) of the general K3
    (K4 phase A with `backward`) for a tile of T rows on `kind`, as
    `tc_shape` and `cc_smem` in csrc/decode_any.cuh lay them out."""
    L = spec.L1 + spec.L3
    pad = TC_KC if kind == "tensor_cores" else F32_PAD
    Hp = _rup(spec.H, pad)
    kmax = max(_rup(spec.x1, pad), _rup(spec.H + spec.E, pad))
    if kind == "tensor_cores":
        lda, ldb, ldg, gxs = kmax + TC_PAD, min(GENERAL_BLOCK, Hp) + TC_PAD, \
            Hp + TC_PAD, kmax + 4
        stage = TC_KC * ldb
        if backward:
            stage = max(stage, min(GENERAL_BLOCK, kmax) * (TC_KC + TC_PAD))
        u = 2 * T * lda * 2
        if backward:
            u = max(u, T * gxs * 4)
        ring = u + ((T * ldg * 2 + L * T * (Hp // 32) * 4) if backward else 0)
        ring = _rup(ring, 16)
        return ring + TC_STAGES * stage * 2 + 3 * T * 4, 0
    cw, ld = GENERAL_CC_ROWS // T, T + 4
    state = kmax * ld * (2 if ws else 1)
    if backward:
        state += Hp * ld + L * T * -(-Hp // 32)
    kc, stages = GENERAL_CC_RING
    smem = 4 * ((0 if ws else state) + stages * kc * cw + 3 * T)
    return smem, (state if ws else 0)


def general_plan(spec: DecodeSpec, backward: bool = False) -> GeneralPlan:
    """The general kernels' plan (`plan` in csrc/decode_any.cuh): bf16 on
    the tensor cores with the largest tile of GENERAL_TILES whose state fits
    a block's shared memory; else (f32, or a bf16 spec too wide for a tile
    of 16) on the CUDA cores with the largest tile that fits and covers Hp
    in one pass of GENERAL_CC_ROWS / T columns; else on the CUDA cores with
    the activations in a workspace slice per CTA (T = 64), the one
    workspace placement."""
    def make(kind, T, ws):
        pad = TC_KC if kind == "tensor_cores" else F32_PAD
        smem, wsf = general_smem(spec, kind, T, backward, ws)
        K = spec.K
        return GeneralPlan(kind, T, T // K if K <= T else 1,
                           1 if K <= T else -(-K // T), smem, wsf,
                           _rup(spec.H, pad), _rup(spec.x1, pad),
                           _rup(spec.H + spec.E, pad))
    if spec.bf16:
        for T in GENERAL_TILES:
            p = make("tensor_cores", T, False)
            if p.smem <= SMEM_BYTES:
                return p
    for T in GENERAL_TILES:
        p = make("cuda_cores", T, False)
        if p.Hp <= GENERAL_CC_ROWS // T and p.smem <= SMEM_BYTES:
            return p
    return make("cuda_cores", 64, True)


def general_pads(spec: DecodeSpec, plan: GeneralPlan) -> List[int]:
    """Each layer's padded input width kp_l under `plan`."""
    return [plan.kp0 if i == 0 else plan.kpE if i == spec.L1 else plan.Hp
            for i in range(spec.L1 + spec.L3)]


_KIND = ("tensor_cores", "cuda_cores")
_ANY_ARGS = {
    "fused_decode_any_plan": [ctypes.c_longlong] + [_CI] * 10
    + [ctypes.POINTER(_CI)],
    "fused_decode_any_launch": [_VP] * 8 + [ctypes.c_longlong] + [_CI] * 9
    + [_CF, _CI, _CI] + [_VP] * 8,
    "fused_decode_bwd_any_plan": [ctypes.c_longlong] + [_CI] * 11
    + [ctypes.POINTER(_CI)],
    "fused_decode_bwd_any_launch": [_VP] * 10 + [ctypes.c_longlong]
    + [_CI] * 9 + [_CF, _CI, _CI] + [_VP] * 7 + [_CI] + [_VP] * 3 + [_CI]
    + [_VP] * 6,
}


def _any_lib(name: str):
    lib = "fused_decode_bwd_any" if name.startswith("fused_decode_bwd") \
        else "fused_decode_any"
    return _argtypes(getattr(_build.load(lib), name), _ANY_ARGS[name])


def any_plan(spec: DecodeSpec, M: int, backward: bool = False,
             cap_rows=None) -> GeneralPlan:
    """The plan of a general-kernel launch at M rows as the built kernel
    makes it on the current card: `general_plan`'s fields and the launch's
    (grid; for K4 phase B's shared memory and CTAs along y, and the scratch
    rows, at most `cap_rows`, by default GENERAL_CAP_ROWS). Kept per (spec,
    M, backward, cap, card): the grid comes from an occupancy query."""
    return _any_plan(spec, M, backward, cap_rows or GENERAL_CAP_ROWS,
                     torch.cuda.current_device())


@functools.lru_cache(maxsize=256)
def _any_plan(spec: DecodeSpec, M: int, backward: bool, cap_rows: int,
              _device: int):
    K = spec.K
    if backward:
        out = (_CI * 11)()
        err = _any_lib("fused_decode_bwd_any_plan")(
            M, *_dims(spec), int(spec.bf16), cap_rows, out)
        _build.check(err, "fused_decode_bwd (general, plan)")
        v = list(out)
        T = v[1]
        return GeneralPlan(_KIND[v[0]], T, T // K if K <= T else 1,
                           1 if K <= T else -(-K // T), v[2], v[4], v[6],
                           v[7], v[8], grid=v[5], smem_b=v[3],
                           dw_blocks=v[9], cap=v[10])
    out = (_CI * 10)()
    err = _any_lib("fused_decode_any_plan")(M, *_dims(spec), int(spec.bf16),
                                            out)
    _build.check(err, "fused_decode (general, plan)")
    v = list(out)
    return GeneralPlan(_KIND[v[0]], *v[1:6], *v[7:10], grid=v[6])


def pack_any_weights(Ws: List[torch.Tensor], spec: DecodeSpec,
                     plan: GeneralPlan, backward: bool = False
                     ) -> torch.Tensor:
    """The block weights as the general kernels stream them under `plan`:
    each W_l [in_l, H] zero-padded to [kp_l, Hp], layer after layer, as one
    bf16 buffer on the tensor cores (which read W_l itself for g_z W^T) or
    one f32 buffer on the CUDA cores, there with `backward` followed by
    each padded W_l^T [Hp, kp_l]."""
    padded = [torch.nn.functional.pad(W, (0, plan.Hp - spec.H,
                                          0, kp - W.shape[0]))
              for W, kp in zip(Ws, general_pads(spec, plan))]
    if plan.kind == "tensor_cores":
        return torch.cat([p.to(torch.bfloat16).reshape(-1) for p in padded])
    bwd = [p.t().reshape(-1) for p in padded] if backward else []
    return torch.cat([p.reshape(-1) for p in padded] + bwd).contiguous()


def pack_any_bias(bs: List[torch.Tensor], spec: DecodeSpec,
                  plan: GeneralPlan) -> torch.Tensor:
    """The block biases [L][Hp], zero past H."""
    return torch.cat([torch.nn.functional.pad(b, (0, plan.Hp - spec.H))
                      for b in bs]).contiguous()


def _bwd_any(feat, dists, extras, w, Ws, bs, wa, ba, spec: DecodeSpec,
             g_fagg, g_alpha, keep=None, cap_rows=None):
    """K4 on the general route (csrc/fused_decode_bwd_any.cu): its scratch
    buffers (at most `cap_rows` rows, `any_plan`), then one call that
    builds the live list and launches its phases batch by batch. Returns
    (dparams, (g_feat, g_dists, g_extras, g_w)); a dict `keep` gets the
    plan, the scratch and the live list."""
    M, H, L, dev = feat.shape[0], spec.H, spec.L1 + spec.L3, feat.device
    pl = any_plan(spec, M, backward=True, cap_rows=cap_rows)
    dt = torch.bfloat16 if pl.kind == "tensor_cores" else torch.float32
    P, nsl = param_count(spec), L * H + H + 1
    live = _live_scratch(M // spec.K, dev)
    ws = torch.empty(max(pl.grid * pl.ws, 1), dtype=torch.float32,
                     device=dev)
    # every layer's input, then the last layer's output
    act = torch.empty(pl.cap * (sum(general_pads(spec, pl)) + pl.Hp),
                      dtype=dt, device=dev)
    gz = torch.empty(L * pl.cap * pl.Hp, dtype=dt, device=dev)
    slices = torch.empty(pl.cap // pl.T * nsl, dtype=torch.float64,
                         device=dev)
    sacc = torch.empty(nsl, dtype=torch.float64, device=dev)
    partial = torch.empty(GENERAL_SPLITS * _pad4(P), dtype=torch.float32,
                          device=dev)
    dparams = torch.empty(P, dtype=torch.float32, device=dev)
    out = (torch.empty_like(feat), torch.empty_like(dists),
           torch.empty_like(extras), torch.empty_like(w))
    # the packed weights and biases stay referenced until the launch: a
    # temporary's block would go back to the allocator and could be
    # reused by a later op queued before the kernel
    Wp = pack_any_weights(Ws, spec, pl, backward=True)
    bias = pack_any_bias(bs, spec, pl)
    p = _build.ptr
    err = _any_lib("fused_decode_bwd_any_launch")(
        p(feat), p(dists), p(extras), p(w), p(Wp), p(bias), p(wa), p(ba),
        p(g_fagg), p(g_alpha), M, *_dims(spec), float(spec.neg_slope),
        int(spec.bf16), pl.grid, *[p(t) for t in live], p(ws), p(act),
        p(gz), pl.cap, p(slices), p(sacc), p(partial), GENERAL_SPLITS,
        *[p(t) for t in out], p(dparams), _build.stream_handle(dev))
    _build.check(err, "fused_decode_bwd (general)")
    if keep is not None:
        keep.update(plan=pl, act=act, gz=gz, list=live[2], count=live[3])
    return dparams, out


def general_bwd_scratch(feat, dists, extras, w, params: Dict,
                        spec: DecodeSpec, g_fagg, g_alpha):
    """The general K4 on CUDA tensors with what its phase A wrote, a check's
    view of its rounding points and branches (uncounted), with a scratch
    that takes every row in one batch (phase A's outputs do not depend on
    the batches; dW's sums in f32 do). Returns (`fused_decode_bwd`'s
    result, rows, acts, gzs): rows [n] int64, the n live rows in the order
    the phases take them; acts, each layer's input [n, kp_l] and then the
    last layer's output [n, Hp]; gzs, each layer's rounded g_z [n, Hp]; f32
    (bf16 values in a bf16 spec)."""
    _check(feat, dists, extras, w, spec)
    if feat.device.type == "cpu" or route(spec, backward=True) != "general":
        raise ValueError("general_bwd_scratch: needs CUDA tensors and a "
                         "spec on the general route")
    Ws, bs, wa, ba = _device_weights(params, spec, feat.device)
    keep = {}
    dparams, rows = _bwd_any(feat, dists, extras, w, Ws, bs, wa, ba, spec,
                             g_fagg, g_alpha, keep,
                             cap_rows=feat.shape[0] + GENERAL_TILES[0])
    pl, K = keep["plan"], spec.K
    groups = keep["list"][:int(keep["count"].item())].long()
    n = groups.numel() * K
    acts, off = [], 0
    for kp in general_pads(spec, pl) + [pl.Hp]:
        acts.append(keep["act"][off:off + n * kp].view(n, kp).float())
        off += pl.cap * kp
    gzs = [keep["gz"].view(-1, pl.cap, pl.Hp)[l, :n].float()
           for l in range(spec.L1 + spec.L3)]
    live = (groups[:, None] * K
            + torch.arange(K, device=feat.device)).reshape(-1)
    return ((*rows, _split_params(dparams, params, spec)), live, acts, gzs)


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
fused_decode.launches_by_route = dict.fromkeys(ROUTES, 0)


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
    Ws, bs, wa, ba = _device_weights(params, spec, feat.device)
    r = route(spec, backward=True)
    dparams, rows = {"general": _bwd_any, "tensor_core": _bwd_tc,
                     "cuda_core": _bwd_f32}[r](
        feat, dists, extras, w, Ws, bs, wa, ba, spec, g_fagg, g_alpha)
    _count(fused_decode_bwd, r)
    return (*rows, _split_params(dparams, params, spec))


def _split_params(dparams, params: Dict, spec: DecodeSpec) -> Dict:
    """The flat gradient vector as views in the layout of `params`."""
    flat, off = [], 0
    for t in _flatten(params):
        flat.append(dparams[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return _unflatten(flat, spec)


def _bwd_tc(feat, dists, extras, w, Ws, bs, wa, ba, spec: DecodeSpec,
            g_fagg, g_alpha):
    """K4 on the tensor cores (csrc/fused_decode_bwd_tc.cu): its scratch
    buffers, then one call that launches its three phases. Returns
    (dparams, (g_feat, g_dists, g_extras, g_w))."""
    M, H, L = feat.shape[0], spec.H, spec.L1 + spec.L3
    dev = feat.device
    ntiles = -(-M // TC_ROWS_BWD)
    rows = ntiles * TC_ROWS_BWD
    P = param_count(spec)
    act = torch.empty(rows * sum(tc_pads(spec)), dtype=torch.bfloat16,
                      device=dev)
    gz = torch.empty(L * rows * H, dtype=torch.bfloat16, device=dev)
    flags = torch.empty(ntiles, dtype=torch.int32, device=dev)
    slices = torch.empty(ntiles * (L * H + H + 1), dtype=torch.float32,
                         device=dev)
    partial = torch.empty(TC_SPLITS * _pad4(P), dtype=torch.float32,
                          device=dev)
    dparams = torch.empty(P, dtype=torch.float32, device=dev)
    out = (torch.empty_like(feat), torch.empty_like(dists),
           torch.empty_like(extras), torch.empty_like(w))
    Wt, bias = pack_tc_weights(Ws, spec), torch.cat(bs)
    p = _build.ptr
    err = _tc_lib("fused_decode_bwd_tc_launch")(
        p(feat), p(dists), p(extras), p(w), p(Wt), p(bias), p(wa), p(ba),
        p(g_fagg), p(g_alpha), M, *_dims(spec), float(spec.neg_slope),
        *[p(t) for t in out], p(act), p(gz), p(flags), p(slices), p(partial),
        TC_SPLITS, p(dparams), _build.stream_handle(dev))
    _build.check(err, "fused_decode_bwd (tensor cores)")
    return dparams, out


def bwd_f32_cap(M: int) -> int:
    """Rows of K4 f32's scratch for M rows: every tile's, at most
    F32_CAP_ROWS (the batch the phases take at a time)."""
    return min(F32_CAP_ROWS, max(-(-M // F32_ROWS), 1) * F32_ROWS)


def _bwd_f32(feat, dists, extras, w, Ws, bs, wa, ba, spec: DecodeSpec,
             g_fagg, g_alpha):
    """K4 on the CUDA cores (csrc/fused_decode_bwd.cu): its scratch buffers,
    then one call that builds the live list and launches its phases.
    Returns (dparams, (g_feat, g_dists, g_extras, g_w))."""
    M, H, L = feat.shape[0], spec.H, spec.L1 + spec.L3
    dev = feat.device
    cap = bwd_f32_cap(M)
    P = param_count(spec)
    live = _live_scratch(M // spec.K, dev)
    act = torch.empty(cap * sum(f32_pads(spec)[1]), dtype=torch.float32,
                      device=dev)
    gz = torch.empty(L * cap * H, dtype=torch.float32, device=dev)
    slices = torch.empty(max(-(-M // F32_ROWS), 1) * (L * H + H + 1),
                         dtype=torch.float32, device=dev)
    partial = torch.empty(F32_SPLITS * _pad4(P), dtype=torch.float32,
                          device=dev)
    dparams = torch.empty(P, dtype=torch.float32, device=dev)
    out = (torch.empty_like(feat), torch.empty_like(dists),
           torch.empty_like(extras), torch.empty_like(w))
    Wp, bias = pack_f32_weights(Ws, spec, backward=True), torch.cat(bs)
    p = _build.ptr
    err = _f32_lib("fused_decode_bwd_launch")(
        p(feat), p(dists), p(extras), p(w), p(Wp), p(bias), p(wa), p(ba),
        p(g_fagg), p(g_alpha), M, *_dims(spec), float(spec.neg_slope),
        *[p(t) for t in out], *[p(t) for t in live], p(act), p(gz), cap,
        p(slices), p(partial), F32_SPLITS, p(dparams),
        _build.stream_handle(dev))
    _build.check(err, "fused_decode_bwd")
    return dparams, out


fused_decode_bwd.launches = 0
fused_decode_bwd.launches_by_route = dict.fromkeys(ROUTES, 0)


def flops(M: int, spec: DecodeSpec) -> int:
    """Multiply-adds x 2 of the decode's matrix products for M rows."""
    return 2 * M * (sum(d * spec.H for d in layer_inputs(spec)) + spec.H)
