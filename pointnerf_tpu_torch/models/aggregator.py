"""Point aggregation + shading MLP.

Counterpart of `pointnerf_tpu/models/aggregator.py`: `init_aggregator_params`
(with `feat_weight`, the learned-weight MLP of feat_intrp / meta_intrp),
`block_dims`, `kernel_consumed_channels`, `fused_decode_supported`,
`compute_dists`, every distance kernel of `_dist_weight`, `_gradient_clamp`
and `aggregate`, with both the fused branch (kernels K3 and K4,
`ops/fused_decode.py`) and the unfused branch, JAX's XLA decode in every
layout (agg_intrp_order 0, 1 and 2, block1 / block2 / block3 present or
not, the agg_*_xyz_mode hooks, alpha and color heads of any depth).
`decode_takes_kernel` picks the branch: on the CPU the flag, on the card
the kernels wherever they compute the function. Parameters are plain dicts
in the JAX layout: `{"block1": [{"w": [in, out], "b": [out]}, ...],
"block3": ..., "alpha": ..., "color": ...}`.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from .. import DeviceLike, resolve_device
from ..config import AggregatorConfig
from ..ops.fused_decode import DecodeSpec, fused_decode
from ..ops.pe import pe_dim, positional_encoding
from ..ops.spherical import sh_basis
from .points import SampledPoints


def _gain(act_type: str) -> float:
    if act_type == "LeakyReLU":
        return math.sqrt(2.0 / (1.0 + 0.01 ** 2))
    if act_type == "ReLU":
        return math.sqrt(2.0)
    return 1.0


def _mlp_init(gen, dims, gain, final_gain, device):
    layers = []
    for i in range(len(dims) - 1):
        g = gain if (final_gain is None or i < len(dims) - 2) else final_gain
        bound = g * math.sqrt(2.0 / (dims[i] + dims[i + 1])) * math.sqrt(3.0)
        w = torch.rand((dims[i], dims[i + 1]), generator=gen) * 2 * bound \
            - bound
        layers.append({"w": w.to(device),
                       "b": torch.zeros(dims[i + 1], device=device)})
    return layers


def fused_envelope(cfg: AggregatorConfig) -> bool:
    """The layouts the fused decode computes (JAX's `fused_decode_supported`
    without the flag). Inside it the JAX package's XLA decode and its
    kernel compute the same function."""
    return (cfg.agg_intrp_order == 2
            and cfg.shading_feature_mlp_layer1 >= 1
            and cfg.shading_feature_mlp_layer2 == 0
            and cfg.shading_feature_mlp_layer3 >= 1
            and cfg.shading_alpha_mlp_layer == 1
            and cfg.act_type == "LeakyReLU"
            and cfg.act_super > 0
            and cfg.agg_feat_xyz_mode == "None"
            and cfg.agg_alpha_xyz_mode == "None"
            and cfg.agg_color_xyz_mode == "None")


def fused_decode_supported(cfg: AggregatorConfig) -> bool:
    """JAX's selection: the flag is on and the config sits inside the fused
    envelope."""
    return cfg.fused_decode and fused_envelope(cfg)


def decode_takes_kernel(cfg: AggregatorConfig, device: torch.device) -> bool:
    """Whether the decode runs the fused formulation: K3, and K4 under a
    gradient, on the card; their plain versions on the CPU.

    On the CPU the flag decides, as in the JAX package, so that the port
    follows JAX's roundings exactly. On CUDA the kernels run whenever the
    config lies inside the fused envelope, whatever `agg.fused_decode`
    says: there the unfused torch decode would compute the kernels'
    function, and the card never runs a kernel's plain twin. Every spec
    inside the envelope has a kernel (`ops/fused_decode.route`: a tuned
    one, or the general one past the tuned ones' limits). Outside the
    envelope the card takes the unfused torch decode, the port of JAX's
    XLA branch."""
    if device.type != "cuda":
        return fused_decode_supported(cfg)
    return fused_envelope(cfg)


def decode_spec(cfg: AggregatorConfig, K: int, bf16: bool) -> DecodeSpec:
    """The fused decode's static shape for this config and K neighbors."""
    return DecodeSpec(
        Fi=cfg.point_features_dim - kernel_consumed_channels(cfg),
        Dd=cfg.dist_dim,
        E=3 * int(bool(cfg.point_color_mode)) + 4 * int(bool(
            cfg.point_dir_mode)),
        Ff=cfg.num_feat_freqs, Fd=abs(cfg.dist_xyz_freq),
        H=cfg.shading_feature_num, K=K,
        L1=cfg.shading_feature_mlp_layer1,
        L3=cfg.shading_feature_mlp_layer3, neg_slope=0.01, bf16=bf16)


def kernel_consumed_channels(cfg: AggregatorConfig) -> int:
    return {"sh_intrp": cfg.sh_degree ** 2,
            "feat_intrp": cfg.weight_feat_dim,
            "meta_intrp": cfg.weight_feat_dim,
            "gau_intrp": 7}.get(cfg.agg_distance_kernel, 0)


def block_dims(cfg: AggregatorConfig) -> Dict[str, int]:
    """Static channel bookkeeping (same numbers as the JAX package)."""
    dist_dim = cfg.dist_dim
    dist_xyz_dim = (dist_dim if cfg.dist_xyz_freq == 0
                    else 2 * abs(cfg.dist_xyz_freq) * dist_dim)
    pnt_ch = pe_dim(3, cfg.num_pos_freqs) if cfg.num_pos_freqs > 0 else 3
    viewdir_ch = 2 * cfg.num_viewdir_freqs * 3 if cfg.num_viewdir_freqs > 0 \
        else 3
    in_ch = cfg.point_features_dim - kernel_consumed_channels(cfg)
    in_ch += 2 * cfg.num_feat_freqs * in_ch if cfg.num_feat_freqs > 0 else 0
    in_ch += dist_xyz_dim if cfg.agg_intrp_order > 0 else 0
    if cfg.agg_feat_xyz_mode != "None":
        in_ch += pnt_ch
    b1_out = cfg.shading_feature_num if cfg.shading_feature_mlp_layer1 > 0 \
        else in_ch
    b2_in = b1_out
    if cfg.shading_feature_mlp_layer2 > 0:
        b2_in += pnt_ch if cfg.agg_feat_xyz_mode != "None" else 0
        b2_in += (dist_xyz_dim if (cfg.agg_intrp_order > 0
                                   and cfg.num_feat_freqs == 0) else 0)
        b2_out = cfg.shading_feature_num
    else:
        b2_out = b1_out
    b3_in = b2_out
    if cfg.shading_feature_mlp_layer3 > 0:
        b3_in += (3 if cfg.point_color_mode else 0) + \
            (4 if cfg.point_dir_mode else 0)
        b3_out = cfg.shading_feature_num
    else:
        b3_out = b2_out
    alpha_in = b3_out + (pnt_ch if cfg.agg_alpha_xyz_mode != "None" else 0)
    color_in = b3_out + viewdir_ch + (pnt_ch if cfg.agg_color_xyz_mode
                                      != "None" else 0)
    return dict(in_ch=in_ch, dist_xyz_dim=dist_xyz_dim, pnt_ch=pnt_ch,
                viewdir_ch=viewdir_ch, b1_out=b1_out, b2_in=b2_in,
                b2_out=b2_out, b3_in=b3_in, b3_out=b3_out, alpha_in=alpha_in,
                color_in=color_in)


def init_aggregator_params(cfg: AggregatorConfig,
                           generator: Optional[torch.Generator] = None,
                           device: DeviceLike = None) -> Dict:
    """Xavier-uniform weights and zero biases, drawn on the CPU from
    `generator` and moved to `device` (the JAX package draws other numbers
    from the same seed: tests copy weights with `convert.params_from_jax`)."""
    dev = resolve_device(device)
    d = block_dims(cfg)
    g = _gain(cfg.act_type)
    params: Dict = {}
    H = cfg.shading_feature_num
    if cfg.shading_feature_mlp_layer1 > 0:
        params["block1"] = _mlp_init(
            generator, [d["in_ch"]] + [H] * cfg.shading_feature_mlp_layer1,
            g, g, dev)
    if cfg.shading_feature_mlp_layer2 > 0:
        params["block2"] = _mlp_init(
            generator, [d["b2_in"]] + [H] * cfg.shading_feature_mlp_layer2,
            g, g, dev)
    if cfg.shading_feature_mlp_layer3 > 0:
        params["block3"] = _mlp_init(
            generator, [d["b3_in"]] + [H] * cfg.shading_feature_mlp_layer3,
            g, g, dev)
    half = H // 2
    params["alpha"] = _mlp_init(
        generator, [d["alpha_in"]] + [half] * (cfg.shading_alpha_mlp_layer - 1)
        + [1], g, 1.0, dev)
    params["color"] = _mlp_init(
        generator, [d["color_in"]] + [half] * (cfg.shading_color_mlp_layer - 1)
        + [cfg.shading_color_channel_num], g, 1.0, dev)
    if cfg.agg_distance_kernel in ("feat_intrp", "meta_intrp"):
        # the learned-weight MLP over [PE(dists), the leading
        # weight_feat_dim feature channels] (JAX's completion of the
        # reference's declared design)
        w_in = pe_dim(3, cfg.weight_xyz_freq) + cfg.weight_feat_dim
        params["feat_weight"] = _mlp_init(
            generator, [w_in, w_in // 2, w_in // 2, 1], g, g, dev)
    return params


def _rpy_to_matrix(rpy):
    """Roll-pitch-yaw -> rotation matrices [..., 3, 3]."""
    c, s = torch.cos(rpy), torch.sin(rpy)
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
    rot = torch.stack(
        [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
         sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx,
         -sy, cy * sx, cy * cx], -1)
    return rot.reshape(rpy.shape[:-1] + (3, 3))


def _leaky_relu(x):
    """jax.nn.leaky_relu's form: slope 1 at exactly 0 (F.leaky_relu's is
    0.01 there)."""
    return torch.where(x >= 0, x, 0.01 * x)


def _dist_weight(cfg: AggregatorConfig, dists, pnt_mask, vsize,
                 features=None, params=None):
    """Per-neighbor weights of the distance kernel, returned as
    (w, pre_normed). JAX's function, quirks included: numlinear and
    numquadric take the norm over every dists channel and come back
    normalized by the neighbor count; trilinear divides by vsize[0] and
    gau_intrp scales by vsize[2]; quadric with a non-uniform axis weight
    needs dists channels that broadcast against its three weights."""
    axis_w = cfg.agg_axis_weight
    uniform_axis = axis_w is None or tuple(axis_w) == (1, 1, 1)
    name = cfg.agg_distance_kernel
    if name == "sh_intrp":
        # the SH basis of each neighbor's direction against its leading
        # sh_degree² feature channels as coefficients
        acts = {"sigmoid": torch.sigmoid, "tanh": torch.tanh}
        if cfg.sh_act not in acts:
            raise ValueError(f"unsupported sh_act {cfg.sh_act!r}")
        d3 = dists[..., :3]
        dn = torch.linalg.norm(d3, dim=-1)
        dirs = d3 / dn[..., None].clamp(min=1e-8)
        shall = sh_basis(cfg.sh_degree, dirs)
        coefs = features[..., :cfg.sh_degree ** 2]
        if cfg.sh_dist_func == "sh_quadric":
            df = 1.0 / (dn * dn).clamp(min=1e-8)
        elif cfg.sh_dist_func == "sh_linear":
            df = 1.0 / dn.clamp(min=1e-8)
        else:
            raise ValueError(
                f"unsupported sh_dist_func {cfg.sh_dist_func!r}")
        w = pnt_mask * torch.sum(acts[cfg.sh_act](shall * coefs), -1) * df
        return w, False
    if name == "linear":
        if uniform_axis:
            w = 1.0 / torch.linalg.norm(dists[..., :3], dim=-1).clamp(
                min=1e-6)
        else:
            w = 1.0 / (torch.sqrt(torch.sum(dists[..., :2] ** 2, -1))
                       * axis_w[0] + dists[..., 2].abs() * axis_w[1]
                       ).clamp(min=1e-6)
        return pnt_mask * w, False
    if name == "numlinear":
        w = pnt_mask * (1.0 / torch.linalg.norm(dists, dim=-1).clamp(
            min=1e-6))
        return w / pnt_mask.sum(-1, keepdim=True).clamp(min=1), True
    if name == "quadric":
        if uniform_axis:
            w = 1.0 / torch.sum(dists[..., :3] ** 2, -1).clamp(min=1e-8)
        else:
            if dists.shape[-1] not in (1, 3):
                raise ValueError(
                    f"quadric with agg_axis_weight {tuple(axis_w)}: "
                    f"incompatible shapes for broadcasting, dists "
                    f"{tuple(dists.shape)} and the axis weights (3,)")
            aw = torch.tensor(axis_w, dtype=dists.dtype, device=dists.device)
            w = 1.0 / torch.sum(dists ** 2 * aw, -1).clamp(min=1e-8)
        return pnt_mask * w, False
    if name == "numquadric":
        w = pnt_mask * (1.0 / torch.sum(dists ** 2, -1).clamp(min=1e-8))
        return w / pnt_mask.sum(-1, keepdim=True).clamp(min=1), True
    if name == "avg":
        return pnt_mask * 1.0, False
    if name in ("feat_intrp", "meta_intrp"):
        # learned weights: sigmoid(MLP([PE(dists), the leading
        # weight_feat_dim feature channels])); meta_intrp is an alias
        pe = positional_encoding(dists[..., :3], cfg.weight_xyz_freq)
        h = torch.cat([pe, features[..., :cfg.weight_feat_dim]], -1)
        layers = params["feat_weight"]
        for layer in layers[:-1]:
            h = _leaky_relu(_dense(layer, h))
        w = torch.sigmoid(_dense(layers[-1], h))[..., 0]
        return pnt_mask * w, False
    if name == "gau_intrp":
        # a per-point anisotropic gaussian: features[0] the scale, [1:4]
        # the radii (sigmoid, x 20 vsize_z), [4:7] roll / pitch / yaw
        # clamped to +-pi/4; w = scale exp(-0.5 |diag(1/r) R d|²)
        scale = features[..., 0].abs()
        radii = vsize[2] * 20.0 * torch.sigmoid(features[..., 1:4])
        rpy = features[..., 4:7].clamp(-math.pi / 4, math.pi / 4)
        tx = _rpy_to_matrix(rpy) / (radii[..., :, None] + 1e-8)
        gd = torch.einsum("...ij,...j->...i", tx, dists[..., :3])
        w = scale * torch.exp(-0.5 * torch.sum(gd ** 2, -1))
        return pnt_mask * w, False
    if name == "trilinear":
        d = 1.0 - (dists * pnt_mask[..., None] / vsize[0]).abs()
        w = pnt_mask * d[..., 0] * d[..., 1] * d[..., 2]
        return w / w.sum(-1, keepdim=True).clamp(min=1e-8), True
    raise ValueError(f"unknown agg_distance_kernel {name}")


def compute_dists(cfg: AggregatorConfig, sp: SampledPoints, sample_loc,
                  sample_loc_w, sample_ray_dirs):
    """agg_dist_pers dispatch (modes -1, 0, 1, 2, 10, 20, 30)."""
    mode = cfg.agg_dist_pers
    if mode < 0:
        return sample_loc_w[..., None, :].expand(sp.xyz.shape)
    if mode == 0:
        return sp.xyz - sample_loc_w[..., None, :]
    if mode == 1:
        return sp.xyz_pers - sample_loc[..., None, :]
    if mode in (2, 20):
        xdist = (sp.xyz_pers[..., 0] * sp.xyz_pers[..., 2]
                 - sample_loc[..., None, 0] * sample_loc[..., None, 2])
        ydist = (sp.xyz_pers[..., 1] * sp.xyz_pers[..., 2]
                 - sample_loc[..., None, 1] * sample_loc[..., None, 2])
        zdist = sp.xyz_pers[..., 2] - sample_loc[..., None, 2]
        pers = torch.stack([xdist, ydist, zdist], -1)
        if mode == 2:
            return pers
        return torch.cat([sp.xyz - sample_loc_w[..., None, :], pers], -1)
    if mode == 10:
        pers = sp.xyz_pers - sample_loc[..., None, :]
        return torch.cat([sp.xyz - sample_loc_w[..., None, :], pers], -1)
    if mode == 30:
        w_dists = sp.xyz - sample_loc_w[..., None, :]
        proj = torch.sum(w_dists * sample_ray_dirs[..., None, :], -1,
                         keepdim=True)
        return torch.cat([proj, w_dists], -1)
    raise ValueError(f"illegal agg_dist_pers {mode}")


def _gradient_clamp(conf, lo=0.0001, hi=1.0):
    """Straight-through clamp: the forward value is clamp(conf)."""
    return conf - (conf - conf.clamp(lo, hi)).detach()


class AggOutput(NamedTuple):
    features: torch.Tensor          # [..., SR, C+1] sigma ++ color
    ray_valid: torch.Tensor         # [..., SR] bool
    weight: torch.Tensor            # [..., SR, K]
    conf_coefficient: torch.Tensor  # [..., SR, K]


def _act(cfg: AggregatorConfig, x):
    if cfg.act_type == "LeakyReLU":
        return _leaky_relu(x)
    if cfg.act_type == "ReLU":
        return torch.relu(x)
    raise ValueError(f"unsupported act_type {cfg.act_type}")


def _dense(p, x):
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


def _dense_parts(p, parts):
    """_dense over the virtual concatenation of `parts` along -1, as JAX's
    XLA decode computes it: one product per part against its rows of W,
    summed (in bf16 each part's product rounds on its own)."""
    if len(parts) == 1:
        return _dense(p, parts[0])
    off, acc = 0, None
    for t in parts:
        n = t.shape[-1]
        y = t @ p["w"][off:off + n].to(t.dtype)
        acc = y if acc is None else acc + y
        off += n
    if off != p["w"].shape[0]:
        raise ValueError(f"_dense_parts: parts of {off} channels for a "
                         f"layer of {p['w'].shape[0]} inputs")
    return acc + p["b"].to(acc.dtype)


def _raw2color(cfg, raw):
    c = torch.sigmoid(raw)
    if cfg.act_super > 0:
        c = c * (1 + 2 * 0.001) - 0.001
    return c


def _raw2density(cfg, raw):
    if cfg.act_super > 0:
        return torch.nn.functional.softplus(raw - 1.0)
    return torch.relu(raw)


def _mlp(cfg, layers, parts):
    """A head over the parts of its input: act between layers, none after
    the last."""
    if len(layers) == 1:
        return _dense_parts(layers[0], parts)
    x = _act(cfg, _dense_parts(layers[0], parts))
    for layer in layers[1:-1]:
        x = _act(cfg, _dense(layer, x))
    return _dense(layers[-1], x)


def _color_head(params, cfg, fagg, viewdirs_pe, compute_dtype):
    x = torch.cat([fagg, viewdirs_pe.to(compute_dtype)], -1)
    layers = params["color"]
    for layer in layers[:-1]:
        x = _act(cfg, _dense(layer, x))
    return _raw2color(cfg, _dense(layers[-1], x))


def aggregate(params: Dict, cfg: AggregatorConfig, sp: SampledPoints,
              sample_loc, sample_loc_w, sample_ray_dirs, vsize,
              Rw2c: Optional[torch.Tensor] = None,
              compute_dtype=torch.float32) -> AggOutput:
    """Decode per-shading-point density + radiance from K neighbor payloads.
    sp.* [R, SR, K, *]; sample_loc/_w [R, SR, 3]; sample_ray_dirs [R, SR, 3];
    Rw2c a global [3, 3] rotation, per-neighbor rotations [R, SR, K, 3, 3]
    (editing composites: each part keeps its training frame), or None."""
    R, SR, K = sp.mask.shape
    mask = sp.mask
    maskf = mask.to(compute_dtype)
    ray_valid = mask.any(-1)
    zero = torch.zeros((), device=mask.device)
    per_point_rot = Rw2c is not None and Rw2c.dim() == 5

    def rot_local(v):
        """World-frame rows back into the point frame: v @ Rw2c^T."""
        if per_point_rot:
            return torch.einsum("...c,...dc->...d", v, Rw2c.to(v.dtype))
        return v @ Rw2c.T.to(v.dtype)

    dists = compute_dists(cfg, sp, sample_loc, sample_loc_w, sample_ray_dirs)
    dists = torch.where(mask[..., None], dists, zero)
    weight, pre_normed = _dist_weight(cfg, dists, maskf, vsize,
                                      features=sp.features, params=params)
    if cfg.agg_weight_norm > 0 and not pre_normed:
        weight = weight / weight.sum(-1, keepdim=True).clamp(min=1e-8)
    conf_coeff = (_gradient_clamp(sp.conf[..., 0]) if cfg.point_conf_mode
                  else torch.ones_like(weight))
    w = (weight * conf_coeff)[..., None].to(compute_dtype)       # [R,SR,K,1]

    viewdirs = sample_ray_dirs
    if per_point_rot:
        viewdirs = rot_local(viewdirs[..., None, :].expand(R, SR, K, 3))
    elif Rw2c is not None:
        viewdirs = rot_local(viewdirs)
    if cfg.num_viewdir_freqs > 0:
        vpe = positional_encoding(viewdirs, cfg.num_viewdir_freqs, ori=True)
        ori_viewdirs, viewdirs_pe = vpe[..., :3], vpe[..., 3:]
    else:
        ori_viewdirs, viewdirs_pe = viewdirs, viewdirs
    if per_point_rot:
        # the color head runs per shading point: the per-neighbor rotated
        # view-direction PE is summed with the NORMALIZED weights, so one
        # part at R = I gives the global path (JAX's documented deviation
        # from the reference's broadcast)
        wn = w / w.sum(-2, keepdim=True).clamp(min=1e-8)
        viewdirs_pe = (viewdirs_pe * wn).sum(-2)

    dists_flat = dists
    if cfg.dist_xyz_deno != 0.0:
        dists_flat = dists_flat / (cfg.dist_xyz_deno * float(
            torch.linalg.norm(torch.tensor(vsize, dtype=torch.float32))))
    if Rw2c is not None and cfg.dist_dim >= 3:
        dists_flat = torch.cat([rot_local(dists_flat[..., :3]),
                                dists_flat[..., 3:]], -1)

    feat = sp.features[..., kernel_consumed_channels(cfg):]
    feat = torch.where(mask[..., None], feat, zero)

    extras = []
    if cfg.point_color_mode:
        extras.append(torch.where(mask[..., None], sp.color, zero))
    if cfg.point_dir_mode:
        sdir = torch.where(mask[..., None], sp.dirs, zero)
        if Rw2c is not None:
            sdir = rot_local(sdir)
        ov = (ori_viewdirs if per_point_rot
              else ori_viewdirs[..., None, :].expand(sdir.shape))
        extras.append(sdir - ov)
        extras.append(torch.sum(sdir * ov, -1, keepdim=True))

    bf16 = compute_dtype == torch.bfloat16
    if decode_takes_kernel(cfg, mask.device):
        # kernels K3 / K4: PE -> block1 -> block3 -> per-point alpha -> K-sum
        ex = (torch.cat(extras, -1) if extras
              else feat.new_zeros(mask.shape + (0,)))
        spec = decode_spec(cfg, K, bf16=bf16)
        M = R * SR * K
        fagg, alpha = fused_decode(
            feat.reshape(M, -1).float().contiguous(),
            dists_flat.reshape(M, -1).float().contiguous(),
            ex.reshape(M, spec.E).float().contiguous(),
            w.reshape(M, 1).float().contiguous(), params, spec)
        fagg = fagg.reshape(R, SR, -1).to(compute_dtype)
        alpha = alpha.reshape(R, SR, 1)
        color = _color_head(params, cfg, fagg, viewdirs_pe, compute_dtype)
    else:
        alpha, color = _xla_decode(params, cfg, feat, dists_flat, extras, w,
                                   mask, sample_loc_w, viewdirs_pe,
                                   compute_dtype)
    out = torch.cat([alpha.float(), color.float()], -1)
    out = out * ray_valid[..., None]
    return AggOutput(features=out, ray_valid=ray_valid, weight=weight,
                     conf_coefficient=conf_coeff)


def _xla_decode(params, cfg: AggregatorConfig, feat, dists_flat, extras, w,
                mask, sample_loc_w, viewdirs_pe, cdt):
    """JAX's unfused (XLA) decode in every layout, the same function
    through separate torch ops. Every MLP input is a list of parts, each
    entry layer a `_dense_parts` over them. Returns (alpha [R, SR, 1],
    color [R, SR, C])."""
    order = cfg.agg_intrp_order
    hooks = (cfg.agg_feat_xyz_mode, cfg.agg_alpha_xyz_mode,
             cfg.agg_color_xyz_mode)
    pnt_pe = None
    if any(h != "None" for h in hooks):
        pnt_pe = (positional_encoding(sample_loc_w, cfg.num_pos_freqs)
                  if cfg.num_pos_freqs > 0 else sample_loc_w)

    def pnt_part(ref, per_point: bool):
        """The shading point's PE beside `ref`, per neighbor or not."""
        p = pnt_pe
        if per_point:
            p = p[..., None, :].expand(ref.shape[:-1] + (p.shape[-1],))
        return p.to(ref.dtype)

    dists_enc = (positional_encoding(dists_flat, abs(cfg.dist_xyz_freq))
                 if cfg.dist_xyz_freq != 0 else dists_flat)
    if order == 0:
        # interpolate first, then decode per shading point
        fagg = torch.sum(feat * w, -2)
        parts = [fagg.to(cdt)]
        if cfg.num_feat_freqs > 0:
            parts.append(positional_encoding(fagg, cfg.num_feat_freqs)
                         .to(cdt))
        if cfg.agg_feat_xyz_mode != "None":
            parts.append(pnt_part(parts[0], per_point=False))
    else:
        parts = [feat.to(cdt)]
        if cfg.num_feat_freqs > 0:
            parts.append(positional_encoding(feat, cfg.num_feat_freqs)
                         .to(cdt))
        parts.append(dists_enc.to(cdt))
        if cfg.agg_feat_xyz_mode != "None":
            parts.append(pnt_part(parts[0], per_point=True))

    def run_block(name, parts):
        layers = params[name]
        x = _act(cfg, _dense_parts(layers[0], parts))
        for layer in layers[1:]:
            x = _act(cfg, _dense(layer, x))
        return x

    if "block1" in params:
        parts = [run_block("block1", parts)]
    if "block2" in params:
        if cfg.agg_feat_xyz_mode != "None":
            parts = parts + [pnt_part(parts[0], per_point=order > 0)]
        if order > 0 and cfg.num_feat_freqs == 0:
            parts = parts + [dists_enc.to(cdt)]
        parts = [run_block("block2", parts)]
    if "block3" in params:
        ins = list(parts) + [e.to(cdt) for e in extras]
        if order == 0:
            ins = ins[:1] + [torch.sum(e * w, -2) for e in ins[1:]]
        parts = [run_block("block3", ins)]
    x = parts[0] if len(parts) == 1 else torch.cat(parts, -1)

    def alpha_input(t, per_point: bool):
        return ([t, pnt_part(t, per_point)]
                if cfg.agg_alpha_xyz_mode != "None" else [t])

    def color_input(fagg):
        parts = [fagg]
        if cfg.agg_color_xyz_mode != "None":
            parts.append(pnt_part(fagg, per_point=False))
        parts.append(viewdirs_pe.to(cdt))
        return parts

    def color_of(fagg):
        return _raw2color(cfg, _mlp(cfg, params["color"],
                                    color_input(fagg)))
    if order == 2:
        # per-point alpha, interpolated; features interpolated
        alpha_pp = _raw2density(cfg, _mlp(cfg, params["alpha"],
                                          alpha_input(x, True)))
        alpha_pp = torch.where(mask[..., None], alpha_pp, 0.0)
        alpha = torch.sum(alpha_pp * w, -2)
        fagg = torch.sum(torch.where(mask[..., None], x, 0.0) * w, -2)
        return alpha, color_of(fagg)
    if order == 1:
        fagg = torch.sum(torch.where(mask[..., None], x, 0.0) * w, -2)
        return (_raw2density(cfg, _mlp(cfg, params["alpha"],
                                       alpha_input(fagg, False))),
                color_of(fagg))
    # order 0: decode per shading point
    return (_raw2density(cfg, _mlp(cfg, params["alpha"],
                                   alpha_input(x, False))), color_of(x))
