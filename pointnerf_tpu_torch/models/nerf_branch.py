"""The radiance-field branch of the proposal-NeRF hybrid.

Counterpart of `pointnerf_tpu/models/nerf_branch.py`: a PE-MLP field that
covers what the point cloud misses. `nerf_importance` samples per ray are
drawn from a coarse field pass's proposal distribution, decoded by the
field, z-merged with the point samples and marched once
(`models/renderer.py::_hybrid_march`).

  init_nerf_params  the MLP: a ReLU trunk, a sigma head (bias -3, so a
                    fresh field starts near-transparent) and a two-layer
                    color head that also sees the view direction
  nerf_eval         (sigma, color) [..., 1 + C] at world points
  coarse_ray_march  stratified Nc samples -> (z, proposal weights, rgb)
  importance_z      inverse-CDF draw of n new z's from the weights

The trunk runs in `compute_dtype` (the render's, float32 at every entry
point, as in JAX); the heads' outputs and the march are float32. The
random draws (`u`) are injected or drawn from a `torch.Generator`.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from .. import DeviceLike, resolve_device
from ..ops.pe import pe_dim, positional_encoding
from ..ops.query import (_draw, _fma, _inverse_cdf, _xla_cumprod,
                         linspace_f32)


def _linear_init(gen, n_in: int, n_out: int, dev) -> Dict:
    lim = math.sqrt(6.0 / (n_in + n_out))
    w = torch.rand((n_in, n_out), generator=gen) * (2 * lim) - lim
    return {"w": w.to(dev), "b": torch.zeros(n_out, device=dev)}


def init_nerf_params(generator: torch.Generator, cfg,
                     device: DeviceLike = None) -> Dict:
    """Xavier-uniform weights drawn on the CPU from `generator`, zero
    biases but the sigma head's (-3: softplus(-3) ~ 0.05, so a fresh field
    does not fog over the point branch). cfg: the full PointNeRFConfig —
    RenderConfig.nerf_* size the MLP, the color head is
    shading_color_channel_num wide."""
    dev = resolve_device(device)
    r = cfg.render
    C = cfg.agg.shading_color_channel_num
    x_in = pe_dim(3, r.nerf_pe_xyz, ori=True)
    d_in = pe_dim(3, r.nerf_pe_dir, ori=True)
    H = r.nerf_hidden
    trunk, n_in = [], x_in
    for _ in range(r.nerf_layers):
        trunk.append(_linear_init(generator, n_in, H, dev))
        n_in = H
    sigma = _linear_init(generator, H, 1, dev)
    sigma["b"] = sigma["b"] - 3.0
    return {"trunk": trunk, "sigma": sigma,
            "rgb1": _linear_init(generator, H + d_in, H // 2, dev),
            "rgb2": _linear_init(generator, H // 2, C, dev)}


def _apply(p: Dict, x: torch.Tensor, dtype=None) -> torch.Tensor:
    if dtype is None or dtype == torch.float32:
        return x @ p["w"] + p["b"]
    return x @ p["w"].to(dtype) + p["b"].to(dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)), with
    no switch to x at large x."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def nerf_eval(params: Dict, xyz: torch.Tensor, viewdir: torch.Tensor, cfg,
              compute_dtype=torch.float32) -> torch.Tensor:
    """Decode [..., 3] world points (+ per-point view directions) to
    [..., 1 + C] (sigma, color): the point aggregator's feature layout, so
    the two branches march together."""
    r = cfg.render
    hx = positional_encoding(xyz, r.nerf_pe_xyz, ori=True)
    nrm = torch.linalg.norm(viewdir, dim=-1, keepdim=True).clamp(min=1e-8)
    hd = positional_encoding(viewdir / nrm, r.nerf_pe_dir, ori=True)
    h = hx.to(compute_dtype)
    for lp in params["trunk"]:
        h = torch.relu(_apply(lp, h, compute_dtype))
    sigma = _softplus(_apply(params["sigma"], h.float()))
    h2 = torch.cat([h, hd.to(compute_dtype)], -1)
    h2 = torch.relu(_apply(params["rgb1"], h2, compute_dtype))
    color = torch.sigmoid(_apply(params["rgb2"], h2.float()))
    return torch.cat([sigma, color], -1)


def coarse_ray_march(params: Dict, campos, raydir, cfg, train: bool = False,
                     generator: Optional[torch.Generator] = None,
                     u: Optional[torch.Tensor] = None,
                     compute_dtype=torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The stratified coarse field pass: returns (z [R, Nc], blend weights
    [R, Nc], coarse rgb [R, C]). Each of the Nc bins between near and far
    is sampled at u — `u` [R, Nc] or a draw from `generator` when training
    with one, else 0.5."""
    r = cfg.render
    R, Nc = raydir.shape[0], r.nerf_coarse_samples
    dev = raydir.device
    edges = torch.from_numpy(linspace_f32(r.near_plane, r.far_plane,
                                          Nc + 1)).to(dev)
    lo, hi = edges[:-1], edges[1:]
    if train and (u is not None or generator is not None):
        u = _draw(u, generator, (R, Nc), dev)
    else:
        u = torch.full((R, Nc), 0.5, device=dev)
    z = _fma((hi - lo)[None], u, lo[None])                       # [R, Nc]
    pts = campos[None, None, :] + z[..., None] * raydir[:, None, :]
    feats = nerf_eval(params, pts, raydir[:, None, :].expand(pts.shape), cfg,
                      compute_dtype)                             # [R, Nc, 1+C]
    dists = torch.cat([z[:, 1:] - z[:, :-1],
                       torch.full((R, 1), (r.far_plane - r.near_plane) / Nc,
                                  device=dev)], -1)
    alpha = 1.0 - torch.exp(-feats[..., 0] * dists)
    acc = _xla_cumprod(1.0 - alpha + 1e-10)
    acc = torch.cat([torch.ones_like(acc[:, :1]), acc[:, :-1]], -1)
    w = alpha * acc
    rgb = (w[..., None] * feats[..., 1:]).sum(-2)
    return z, w, rgb


def importance_z(z: torch.Tensor, weights: torch.Tensor, n: int,
                 det: bool = True, generator: Optional[torch.Generator] = None,
                 u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF draw of n new z's [R, n] from the proposal weights (the
    same dense comparison count as `ops.query.sample_pdf`, returning only
    the new samples: they merge with the point samples). With `det` (or no
    draw) u = linspace(0.02, 0.98, n)."""
    R = z.shape[0]
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    if det or (u is None and generator is None):
        u = torch.from_numpy(linspace_f32(0.02, 0.98, n)).to(z.device)
        u = u[None, :].expand(R, n)
    else:
        u = _draw(u, generator, (R, n), z.device)
    return _inverse_cdf(bins, weights, u)[0]
