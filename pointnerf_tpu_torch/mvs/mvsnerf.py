"""MVSNeRF-style volume rendering from a regularized cost volume.

Counterpart of `pointnerf_tpu/mvs/mvsnerf.py`: rays are marched through
the reference view's frustum, each sample's features are trilinearly
interpolated from the neural cost volume (in the reference view's NDC) and
joined by the source images' colors at its projections; a decoder MLP
gives density and radiance, composited by the ray march. In the JAX
module's order: `trilinear_sample_volume`, `MVSNeRFDecoder`,
`MultiHeadAttention`, the reference decoder variants (`RendererOurs` v0,
`RendererAttention` v1, `RendererLinear` v2, `RendererColorFusion`),
`reorder_rgba`, `ReferenceMVSNeRF`, `world_to_ref_ndc`, `render_mvsnerf`
and `MVSNERF_DECODERS`.

The modules are `nn.Module`s whose submodules carry flax's names
(`pts_linears_0`, `Dense_3`, `LayerNorm_0`, ...), so that
`convert.mvsnerf_from_flax` carries a flax tree over name for name. flax
sizes a Dense layer from its input; here the width of the volume-and-color
features is an argument (`in_ch_feat`). Layouts are JAX's: the volume is
[D, h, w, C] and the images [V, H, W, 3], channels last.

The march is the card's rule for K2 (`models/renderer.march_takes_kernel`):
on CUDA without a gradient it is K2 (`ops/fused_march.py`), its blend
weights for the depth recomputed from K2's opacity; under a gradient, and
on the CPU, the plain march, as JAX marches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import PointNeRFConfig
from ..models.ray_march import (alpha_blend, exclusive_transmission,
                                radiance_render, ray_march)
from ..models.renderer import march_takes_kernel
from ..ops.fused_march import fused_march
from ..ops.pe import pe_dim, positional_encoding
from ..ops.query import _lin_t
from ..ops.sample2d import bilinear_sample


def trilinear_sample_volume(vol: torch.Tensor,
                            ndc: torch.Tensor) -> torch.Tensor:
    """vol [D, H, W, C]; ndc [..., 3] in [0, 1]^3 (x -> W, y -> H,
    z -> D). Zero outside, each corner on its own. Returns [..., C]."""
    D, H, W, C = vol.shape
    shape = ndc.shape[:-1]
    ndc = ndc.reshape(-1, 3)
    x = ndc[:, 0] * (W - 1)
    y = ndc[:, 1] * (H - 1)
    z = ndc[:, 2] * (D - 1)
    flat = vol.reshape(D * H * W, C)

    def tap(zi, yi, xi):
        inb = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H) & (zi >= 0)
               & (zi < D))
        idx = ((zi.clamp(0, D - 1) * H + yi.clamp(0, H - 1)) * W
               + xi.clamp(0, W - 1))
        return flat.index_select(0, idx) * inb.to(vol.dtype)[:, None]

    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    tx, ty, tz = (x - x0)[:, None], (y - y0)[:, None], (z - z0)[:, None]
    # clamp before the integer cast, so that a far-off coordinate stays off
    # the volume instead of wrapping round the integer range
    x0i = x0.clamp(-2.0, W + 1.0).long()
    y0i = y0.clamp(-2.0, H + 1.0).long()
    z0i = z0.clamp(-2.0, D + 1.0).long()
    c00 = tap(z0i, y0i, x0i) * (1 - tx) + tap(z0i, y0i, x0i + 1) * tx
    c01 = (tap(z0i, y0i + 1, x0i) * (1 - tx)
           + tap(z0i, y0i + 1, x0i + 1) * tx)
    c10 = (tap(z0i + 1, y0i, x0i) * (1 - tx)
           + tap(z0i + 1, y0i, x0i + 1) * tx)
    c11 = (tap(z0i + 1, y0i + 1, x0i) * (1 - tx)
           + tap(z0i + 1, y0i + 1, x0i + 1) * tx)
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    return (c0 * (1 - tz) + c1 * tz).reshape(shape + (C,))


def _named(module: nn.Module, name: str, layer: nn.Module) -> nn.Module:
    module.add_module(name, layer)
    return layer


class MVSNeRFDecoder(nn.Module):
    """Renderer_ours-style MLP: PE(xyz) + volume features + source colors
    -> skip MLP -> (sigma, rgb), the color head also on PE(dir). flax's
    auto-named Dense_0 ... Dense_{depth + 3}."""

    def __init__(self, in_ch_feat: int, depth: int = 6, width: int = 128,
                 skips: Tuple[int, ...] = (4,), pos_freqs: int = 10,
                 dir_freqs: int = 4):
        super().__init__()
        self.depth, self.skips = depth, tuple(skips)
        self.pos_freqs, self.dir_freqs = pos_freqs, dir_freqs
        inp = pe_dim(3, pos_freqs, True) + in_ch_feat
        n = inp
        for i in range(depth):
            _named(self, f"Dense_{i}", nn.Linear(n, width))
            n = width + (inp if i in self.skips else 0)
        _named(self, f"Dense_{depth}", nn.Linear(n, 1))
        _named(self, f"Dense_{depth + 1}", nn.Linear(n, width))
        _named(self, f"Dense_{depth + 2}",
               nn.Linear(width + pe_dim(3, dir_freqs, True), width // 2))
        _named(self, f"Dense_{depth + 3}", nn.Linear(width // 2, 3))

    def forward(self, xyz, viewdirs, feat):
        L = lambda i: getattr(self, f"Dense_{i}")  # noqa: E731
        p = positional_encoding(xyz, self.pos_freqs, ori=True)
        d = positional_encoding(viewdirs, self.dir_freqs, ori=True)
        h = torch.cat([p, feat], -1)
        inp = h
        for i in range(self.depth):
            h = torch.relu(L(i)(h))
            if i in self.skips:
                h = torch.cat([inp, h], -1)
        sigma = L(self.depth)(h)
        bottleneck = L(self.depth + 1)(h)
        h2 = torch.relu(L(self.depth + 2)(torch.cat([bottleneck, d], -1)))
        rgb = L(self.depth + 3)(h2)
        return torch.cat([torch.relu(sigma), torch.sigmoid(rgb)], -1)


class MultiHeadAttention(nn.Module):
    """Post-LN multi-head attention: bias-free q/k/v/fc projections, a
    residual add, LayerNorm(eps=1e-6); `mask` zeros attention logits per
    query row (set to -1e9)."""

    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.w_qs = nn.Linear(d_model, n_head * d_k, bias=False)
        self.w_ks = nn.Linear(d_model, n_head * d_k, bias=False)
        self.w_vs = nn.Linear(d_model, n_head * d_v, bias=False)
        self.fc = nn.Linear(n_head * d_v, d_model, bias=False)
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, q, k, v, mask=None):
        b, lq, _ = q.shape
        lk = k.shape[1]
        residual = q
        qh = self.w_qs(q).reshape(b, lq, self.n_head, self.d_k).transpose(1, 2)
        kh = self.w_ks(k).reshape(b, lk, self.n_head, self.d_k).transpose(1, 2)
        vh = self.w_vs(v).reshape(b, lk, self.n_head, self.d_v).transpose(1, 2)
        attn = torch.einsum("bhqd,bhkd->bhqk", qh / (self.d_k ** 0.5), kh)
        if mask is not None:
            attn = torch.where(mask[:, None] == 0, torch.full_like(attn, -1e9),
                               attn)
        attn = torch.softmax(attn, -1)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, vh)
        out = out.transpose(1, 2).reshape(b, lq, -1)
        out = self.LayerNorm_0(self.fc(out) + residual)
        return out, attn


class _RendererBiasMLP(nn.Module):
    """The skip-MLP body of Renderer_ours / Renderer_linear: a per-layer
    bias from the features, folded multiplicatively (v0) or additively
    (v2), then a view-dependent color head. x = [pts | feats | views];
    returns (rgb, alpha)."""
    bias_mul = True

    def __init__(self, D: int = 8, W: int = 256, in_ch_pts: int = 63,
                 in_ch_views: int = 27, in_ch_feat: int = 17,
                 skips: Tuple[int, ...] = (4,)):
        super().__init__()
        self.D, self.W, self.skips = D, W, tuple(skips)
        self.in_ch_pts, self.in_ch_views = in_ch_pts, in_ch_views
        self.pts_bias = nn.Linear(in_ch_feat, W)
        n = in_ch_pts
        for i in range(D):
            _named(self, f"pts_linears_{i}", nn.Linear(n, W))
            n = W + (in_ch_pts if i in self.skips else 0)
        self.alpha_linear = nn.Linear(n, 1)
        self.feature_linear = nn.Linear(n, W)
        self.views_linears_0 = nn.Linear(W + in_ch_views, W // 2)
        self.rgb_linear = nn.Linear(W // 2, 3)

    def forward(self, x):
        pts = x[..., :self.in_ch_pts]
        views = x[..., -self.in_ch_views:]
        feats = x[..., self.in_ch_pts:-self.in_ch_views]
        bias = self.pts_bias(feats)
        h = pts
        for i in range(self.D):
            z = getattr(self, f"pts_linears_{i}")(h)
            h = torch.relu(z * bias if self.bias_mul else z + bias)
            if i in self.skips:
                h = torch.cat([pts, h], -1)
        alpha = torch.relu(self.alpha_linear(h))
        feature = self.feature_linear(h)
        h = torch.relu(self.views_linears_0(torch.cat([feature, views], -1)))
        rgb = torch.sigmoid(self.rgb_linear(h))
        return torch.cat([rgb, alpha], -1)


class RendererOurs(_RendererBiasMLP):
    """net_type v0 (Renderer_ours): the skip MLP over PE(pts) MULTIPLIED by
    a per-sample bias from the volume features."""
    bias_mul = True


class RendererLinear(_RendererBiasMLP):
    """net_type v2 (Renderer_linear, the default): the feature bias ADDED."""
    bias_mul = False


class RendererAttention(nn.Module):
    """net_type v1 (Renderer_attention): per-view (rgb, mask) tokens fused
    by multi-head attention into per-sample colors, which join the 8
    volume features as the ADDITIVE bias of an MLP without skips. Expects
    feats = [vol8 | V x (rgb, mask)] (rgb alone when feats has 11
    channels). Returns (rgb, alpha, colors, colors), the reference's
    order."""

    def __init__(self, D: int = 8, W: int = 256, in_ch_pts: int = 63,
                 in_ch_views: int = 27, n_views: int = 3):
        super().__init__()
        self.D, self.W, self.n_views = D, W, n_views
        self.in_ch_pts, self.in_ch_views = in_ch_pts, in_ch_views
        self.color_attention = MultiHeadAttention(4, 12, 4, 4)
        self.weight_out = nn.Linear(12, 3)
        self.pts_bias = nn.Linear(8 + 3, W)
        n = in_ch_pts
        for i in range(D):
            _named(self, f"pts_linears_{i}", nn.Linear(n, W))
            n = W
        self.alpha_linear = nn.Linear(W, 1)
        self.feature_linear = nn.Linear(W, W)
        self.views_linears_0 = nn.Linear(W + in_ch_views, W // 2)
        self.rgb_linear = nn.Linear(W // 2, 3)

    def forward(self, x):
        NR, NS, _ = x.shape
        pts = x[..., :self.in_ch_pts]
        views = x[..., -self.in_ch_views:]
        feats = x[..., self.in_ch_pts:-self.in_ch_views]
        if feats.shape[-1] > 8 + 3:
            # the per-view tokens must be rgb + validity mask: an rgb-only
            # packing would be misread as masks
            if feats.shape[-1] != 8 + 4 * self.n_views:
                raise ValueError(
                    f"Renderer_attention expects feats = vol8 + "
                    f"{self.n_views} rgba view tokens "
                    f"({8 + 4 * self.n_views} ch; render with "
                    f"per_view_rgba=True), got {feats.shape[-1]} ch")
            colors_in = feats[..., 8:].reshape(NR * NS, self.n_views, 4)
            tok = torch.cat([colors_in, feats[..., :8].reshape(
                NR * NS, 1, 8).expand(-1, colors_in.shape[1], 8)], -1)
            tok, _ = self.color_attention(tok, tok, tok)
            colors = torch.sigmoid(self.weight_out(tok)).sum(-2).reshape(
                NR, NS, 3)
        else:
            colors = feats[..., -3:]
        bias = self.pts_bias(torch.cat([feats[..., :8], colors], -1))
        h = pts
        for i in range(self.D):
            h = torch.relu(getattr(self, f"pts_linears_{i}")(h) + bias)
        alpha = torch.relu(self.alpha_linear(h))
        feature = self.feature_linear(h)
        h = torch.relu(self.views_linears_0(torch.cat([feature, views], -1)))
        rgb = torch.sigmoid(self.rgb_linear(h))
        return torch.cat([rgb, alpha, colors, colors], -1)


class RendererColorFusion(nn.Module):
    """Renderer_color_fusion: the multiplicative-bias skip MLP; the color is
    attention over per-view (feature16, view-direction token, rgb) masked
    by each view's validity channel, summed over the views. Returns
    (rgb, alpha)."""

    def __init__(self, D: int = 8, W: int = 128, in_ch_pts: int = 63,
                 in_ch_views: int = 27, n_views: int = 3,
                 skips: Tuple[int, ...] = (4,)):
        super().__init__()
        if in_ch_views % n_views:
            raise ValueError(
                f"in_ch_views={in_ch_views} must split across "
                f"n_views={n_views} dir tokens")
        self.D, self.W, self.n_views, self.skips = D, W, n_views, tuple(skips)
        self.in_ch_pts, self.in_ch_views = in_ch_pts, in_ch_views
        self.pts_bias = nn.Linear(8 + 4 * n_views, W)
        n = in_ch_pts
        for i in range(D):
            _named(self, f"pts_linears_{i}", nn.Linear(n, W))
            n = W + (in_ch_pts if i in self.skips else 0)
        self.alpha_linear = nn.Linear(n, 1)
        self.feature_linear = nn.Linear(n, 16)
        att_dim = 16 + 3 + in_ch_views // n_views
        self.ray_attention = MultiHeadAttention(4, att_dim, 4, 4)
        self.rgb_out = nn.Linear(att_dim, 3)

    def forward(self, x):
        NR, NS, _ = x.shape
        V = self.n_views
        pts = x[..., :self.in_ch_pts]
        views = x[..., -self.in_ch_views:]
        feats = x[..., self.in_ch_pts:-self.in_ch_views]
        if feats.shape[-1] != 8 + 4 * V:
            raise ValueError(
                f"Renderer_color_fusion expects feats = vol8 + {V} rgba "
                f"view tokens ({8 + 4 * V} ch; render with "
                f"per_view_rgba=True), got {feats.shape[-1]} ch")
        bias = self.pts_bias(feats)
        h = pts
        for i in range(self.D):
            h = torch.relu(getattr(self, f"pts_linears_{i}")(h) * bias)
            if i in self.skips:
                h = torch.cat([pts, h], -1)
        alpha = torch.relu(self.alpha_linear(h))
        views_t = views.reshape(NR * NS, V, self.in_ch_views // V)
        rgba = feats[..., 8:].reshape(NR * NS, V, 4)
        feature = torch.relu(self.feature_linear(h))
        tok = feature.reshape(NR * NS, 1, 16).expand(-1, V, 16)
        tok = torch.cat([tok, views_t, rgba[..., :3]], -1)
        tok, _ = self.ray_attention(tok, tok, tok, mask=rgba[..., -1:])
        rgb = torch.sigmoid(self.rgb_out(tok)).sum(1).reshape(NR, NS, 3)
        return torch.cat([rgb, alpha], -1)


MVSNERF_DECODERS = {"v0": RendererOurs, "v1": RendererAttention,
                    "v2": RendererLinear, "color_fusion": RendererColorFusion}


def reorder_rgba(raw: torch.Tensor) -> torch.Tensor:
    """Reference (rgb, alpha, ...) -> the ray march's (alpha, rgb)."""
    return torch.cat([raw[..., 3:4], raw[..., :3]], -1)


class ReferenceMVSNeRF(nn.Module):
    """The MVSNeRF wrapper: PE of the points and directions, the decoder of
    `net_type` (under the name "nerf"), the output in the ray march's
    (sigma, rgb) order. `in_ch_feat` is the width of the features after
    PE(xyz): the volume's 8 channels and 3 (rgb) or, for the attention
    variants, 4 (rgb, validity) per view."""

    def __init__(self, net_type: str = "v2", D: int = 8, W: int = 256,
                 pos_freqs: int = 10, dir_freqs: int = 4, n_views: int = 3,
                 in_ch_feat: Optional[int] = None):
        super().__init__()
        self.net_type, self.n_views = net_type, n_views
        self.pos_freqs, self.dir_freqs = pos_freqs, dir_freqs
        attention = net_type in ("v1", "color_fusion")
        kw = dict(D=D, W=128 if net_type == "color_fusion" else W,
                  in_ch_pts=pe_dim(3, pos_freqs, True),
                  in_ch_views=pe_dim(3, dir_freqs, True))
        if attention:
            kw["n_views"] = n_views
        else:
            kw["in_ch_feat"] = (8 + 3 * n_views if in_ch_feat is None
                                else in_ch_feat)
        self.nerf = MVSNERF_DECODERS[net_type](**kw)

    def forward(self, xyz, viewdirs, feat):
        p = positional_encoding(xyz, self.pos_freqs, ori=True)
        d = positional_encoding(viewdirs, self.dir_freqs, ori=True)
        x = torch.cat([p, feat, d], -1)
        squeeze = x.dim() == 2          # the attention variants need [R, S, .]
        raw = self.nerf(x[None] if squeeze else x)
        return reorder_rgba(raw[0] if squeeze else raw)


def world_to_ref_ndc(xyz_w, w2c_ref, K_ref, near: float, far: float,
                     W: int, H: int):
    """World points -> the reference frustum's NDC in [0, 1]^3."""
    ones = torch.ones_like(xyz_w[..., :1])
    cam = (torch.cat([xyz_w, ones], -1) @ w2c_ref.T)[..., :3]
    pix = cam @ K_ref.T
    den = pix[..., 2].clamp(min=1e-9)
    x = pix[..., 0] / den / (W - 1)
    y = pix[..., 1] / den / (H - 1)
    z = (cam[..., 2] - near) / (far - near)
    return torch.stack([x, y, z], -1)


def _tvals(near: float, far: float, R: int, S: int, dev,
           u: Optional[torch.Tensor]) -> torch.Tensor:
    """The sample depths [R, S]: S points from near to far, jittered within
    their bins by the uniform draw `u` [R, S] when given."""
    t = _lin_t(S, dev)
    tvals = near * (1 - t) + far * t
    if u is None:
        return tvals[None].expand(R, S)
    mids = 0.5 * (tvals[1:] + tvals[:-1])
    upper = torch.cat([mids, tvals[-1:]])
    lower = torch.cat([tvals[:1], mids])
    return lower[None] + (upper - lower)[None] * u


# MVSNeRF's march as the card's rule sees it: a radiance render and an
# alpha blend, render.fused_march off (the CPU's plain march, as JAX's)
_MARCH = PointNeRFConfig()


def render_mvsnerf(decoder: nn.Module, volume: torch.Tensor,
                   images: torch.Tensor, Ks: torch.Tensor, w2cs: torch.Tensor,
                   campos: torch.Tensor, raydir: torch.Tensor, near: float,
                   far: float, n_samples: int = 64,
                   bg_color: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   u: Optional[torch.Tensor] = None,
                   per_view_rgba: bool = False, train: bool = False):
    """March rays through the volume (the reference's `rendering`).

    decoder: a module taking (xyz, viewdirs, feat) and returning (sigma,
    rgb) per sample (`ReferenceMVSNeRF`, `MVSNeRFDecoder`); volume
    [D, h, w, C] (the neural cost volume of reference view 0); images
    [V, H, W, 3]; Ks, w2cs [V, 3, 3], [V, 4, 4]; raydir [R, 3]. The samples
    are jittered by `u` [R, S] (JAX's draw, for the tests) or by a draw
    from `generator`; neither: evenly spaced. The march follows the card's
    rule (`renderer.march_takes_kernel`): serving (`train` False) on CUDA
    is kernel K2, with no gradient; training, and the CPU, take the plain
    march, as JAX does. Returns (rgb [R, 3], depth [R], weights [R, S])."""
    V, H, W, _ = images.shape
    dev = raydir.device
    if (isinstance(decoder, ReferenceMVSNeRF)
            and decoder.net_type in ("v1", "color_fusion")):
        # the attention decoders read per-view (rgb, validity) tokens
        if not per_view_rgba:
            raise ValueError(f"net_type={decoder.net_type} requires "
                             f"per_view_rgba=True")
        if V != decoder.n_views:
            raise ValueError(f"net_type={decoder.net_type} built for "
                             f"{decoder.n_views} views, got {V} images")
    R = raydir.shape[0]
    if u is None and generator is not None:
        u = torch.rand((R, n_samples), generator=generator, device=dev)
    tvals = _tvals(near, far, R, n_samples, dev, u)
    xyz = campos[None, None] + raydir[:, None] * tvals[..., None]

    ndc = world_to_ref_ndc(xyz, w2cs[0], Ks[0], near, far, W, H)
    feats = [trilinear_sample_volume(volume, ndc)]            # [R, S, C]
    ones = torch.ones_like(xyz[..., :1])
    for v in range(V):
        cam = (torch.cat([xyz, ones], -1) @ w2cs[v].T)[..., :3]
        z = cam[..., 2].clamp(min=1e-6)
        pix = cam @ Ks[v].T
        px, py = pix[..., 0] / z, pix[..., 1] / z
        feats.append(bilinear_sample(images[v].permute(2, 0, 1), px,
                                     py).movedim(0, -1))
        if per_view_rgba:
            inb = ((px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
                   & (cam[..., 2] > 0))
            feats.append(inb.to(xyz.dtype)[..., None])
    feat = torch.cat(feats, -1)

    dirs = raydir[:, None, :].expand(xyz.shape)
    raw = decoder(xyz, dirs, feat)

    last = tvals[..., -1:] + (far - near) / n_samples
    dists = torch.diff(tvals, dim=-1, append=last)
    dists = dists * torch.linalg.norm(raydir, dim=-1, keepdim=True)
    valid = torch.ones(raw.shape[:-1], dtype=torch.bool, device=dev)
    if march_takes_kernel(_MARCH, dev, train):
        # kernel K2; the blend weights recomputed from its opacity
        C = raw.shape[-1] - 1
        bg = (torch.zeros(C, device=dev) if bg_color is None
              else bg_color.to(torch.float32).contiguous())
        with torch.no_grad():
            rgb, opacity, _bgtr = fused_march(
                dists.detach().contiguous(), valid,
                raw.detach().contiguous(), bg)
            blend_w = opacity * exclusive_transmission(opacity)
            tvals = tvals.detach()
    else:
        (rgb, _pc, _op, _acc, bw, _bgt, _bgw) = ray_march(
            dists, valid, raw, radiance_render, alpha_blend, bg_color)
        blend_w = bw[..., 0]
    depth = torch.sum(blend_w * tvals, -1)
    return rgb, depth, blend_w

