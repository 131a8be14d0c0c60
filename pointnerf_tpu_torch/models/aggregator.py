"""Point aggregation + shading MLP.

Counterpart of `pointnerf_tpu/models/aggregator.py`: `init_aggregator_params`,
`block_dims`, `kernel_consumed_channels`, `fused_decode_supported`,
`compute_dists`, `_dist_weight` (the `linear` kernel), `_gradient_clamp`
and `aggregate`, with both the fused branch (kernel K3, `ops/fused_decode.py`)
and the unfused branch, JAX's XLA decode (agg_intrp_order = 2, no block2, no
*_xyz_mode hooks). `decode_takes_kernel` picks the branch: on the CPU the
flag, on the card the kernels wherever they compute the function. Parameters are plain dicts in the JAX layout:
`{"block1": [{"w": [in, out], "b": [out]}, ...], "block3": ..., "alpha": ...,
"color": ...}`.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from .. import DeviceLike, not_ported, resolve_device
from ..config import AggregatorConfig
from ..ops.fused_decode import DecodeSpec, fused_decode, kernel_takes
from ..ops.pe import pe_dim, positional_encoding
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


def decode_takes_kernel(cfg: AggregatorConfig, K: int, bf16: bool,
                        device: torch.device, backward: bool) -> bool:
    """Whether the decode runs the fused formulation: K3, and K4 under a
    gradient, on the card; their plain versions on the CPU.

    On the CPU the flag decides, as in the JAX package, so that the port
    follows JAX's roundings exactly. On CUDA the kernels run whenever the
    config lies inside the fused envelope, whatever `agg.fused_decode`
    says: there the unfused torch decode would compute the kernels'
    function, and the card never runs a kernel's plain twin. A config
    inside the envelope but past the port kernels' limits (`kernel_takes`)
    raises, whatever the flag. Outside the envelope the card takes the
    unfused torch decode, the port of JAX's XLA branch."""
    if device.type != "cuda":
        return fused_decode_supported(cfg)
    if not fused_envelope(cfg):
        return False
    spec = decode_spec(cfg, K, bf16=bf16)
    if kernel_takes(spec, backward=backward):
        return True
    what = "decode kernels (K3, K4)" if backward else "decode kernel"
    raise not_ported(f"the fused {what} at H={spec.H}, "
                     f"L1+L3={spec.L1 + spec.L3}, K={spec.K}",
                     "Queue 2, K3 and K4 at JAX's whole fused envelope")


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


def _check_envelope(cfg: AggregatorConfig):
    if cfg.agg_distance_kernel != "linear":
        raise not_ported(f"distance kernel {cfg.agg_distance_kernel!r}",
                         "Queue 1, decode: other distance kernels")
    if (cfg.agg_intrp_order != 2 or cfg.shading_feature_mlp_layer2 > 0
            or cfg.agg_feat_xyz_mode != "None"
            or cfg.agg_alpha_xyz_mode != "None"
            or cfg.agg_color_xyz_mode != "None"
            or cfg.shading_feature_mlp_layer1 < 1
            or cfg.shading_feature_mlp_layer3 < 1
            or cfg.shading_alpha_mlp_layer != 1
            or cfg.act_type not in ("LeakyReLU", "ReLU")):
        raise not_ported("this aggregator layout (interp order, block2, "
                         "xyz hooks)", "Queue 1, decode: full aggregator")


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
    return params


def _dist_weight(cfg: AggregatorConfig, dists, pnt_mask):
    """The `linear` distance kernel (the only one ported; `aggregate`
    checks the envelope): inverse distance, returned as (w, pre_normed)."""
    axis_w = cfg.agg_axis_weight
    if axis_w is None or tuple(axis_w) == (1, 1, 1):
        w = 1.0 / torch.linalg.norm(dists[..., :3], dim=-1).clamp(min=1e-6)
    else:
        w = 1.0 / (torch.sqrt(torch.sum(dists[..., :2] ** 2, -1)) * axis_w[0]
                   + dists[..., 2].abs() * axis_w[1]).clamp(min=1e-6)
    return pnt_mask * w, False


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
        # jax.nn.leaky_relu's form: slope 1 at exactly 0 (F.leaky_relu's
        # is 0.01 there)
        return torch.where(x >= 0, x, 0.01 * x)
    return torch.relu(x)


def _dense(p, x):
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


def _raw2color(cfg, raw):
    c = torch.sigmoid(raw)
    if cfg.act_super > 0:
        c = c * (1 + 2 * 0.001) - 0.001
    return c


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
    _check_envelope(cfg)
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
    weight, pre_normed = _dist_weight(cfg, dists, maskf)
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
    if decode_takes_kernel(cfg, K, bf16, mask.device,
                           backward=torch.is_grad_enabled()):
        # kernel K3: PE -> block1 -> block3 -> per-point alpha -> K-sum
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
    else:
        # unfused branch (JAX's XLA decode): the same function through
        # separate torch ops, rounding each layer's product in bf16
        parts = [feat]
        if cfg.num_feat_freqs > 0:
            parts.append(positional_encoding(feat, cfg.num_feat_freqs))
        parts.append(positional_encoding(dists_flat, abs(cfg.dist_xyz_freq))
                     if cfg.dist_xyz_freq != 0 else dists_flat)
        x = torch.cat(parts, -1).to(compute_dtype)
        for layer in params["block1"]:
            x = _act(cfg, _dense(layer, x))
        x = torch.cat([x] + [e.to(compute_dtype) for e in extras], -1)
        for layer in params["block3"]:
            x = _act(cfg, _dense(layer, x))
        raw = _dense(params["alpha"][0], x)
        alpha_pp = (torch.nn.functional.softplus(raw - 1.0)
                    if cfg.act_super > 0 else torch.relu(raw))
        alpha_pp = torch.where(mask[..., None], alpha_pp, 0.0)
        alpha = torch.sum(alpha_pp * w, -2)
        fagg = torch.sum(torch.where(mask[..., None], x, 0.0) * w, -2)

    color = _color_head(params, cfg, fagg, viewdirs_pe, compute_dtype)
    out = torch.cat([alpha.float(), color.float()], -1)
    out = out * ray_valid[..., None]
    return AggOutput(features=out, ray_valid=ray_valid, weight=weight,
                     conf_coefficient=conf_coeff)
