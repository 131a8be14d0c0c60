"""MVS-based neural-point initialization.

Counterpart of `pointnerf_tpu/mvs/points_init.py` (`view_proj_mats`,
`MvsPointsInit` with `premlp`, `depth_one_view`, `features_only`,
`embed_points`, `init_mvs_points`, `load_pretrained_mvsnet`,
`gen_scene_points`): per init view, MVSNet depth and confidence, the
cross-view geometric filter, then the surviving pixels lifted to world
points with their payloads — FeatureNet samples of every init view at the
points' projections, the reference image's color, the direction from the
reference camera and the confidence, compressed by the `premlp` to
`point_features_dim`.

Variables travel as flax's do: {"params": {name: tensor}, "batch_stats":
{name: tensor}}, keyed by the module's state_dict names
(`convert.mvs_variables_from_jax` carries JAX's across); `mvs_apply` runs a
method of the module with such variables (`torch.func.functional_call`).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import DeviceLike, resolve_device
from ..ops.sample2d import bilinear_sample
from .filter import filter_by_masks
from .mvsnet import FlaxBatchNorm, MVSNet


def view_proj_mats(Ks: np.ndarray, w2cs: np.ndarray, ref: int,
                   scale: float = 0.25) -> np.ndarray:
    """Plane-sweep projections src_proj @ inv(ref_proj) at feature
    resolution (intrinsics x `scale`), in float64 then float32."""
    V = Ks.shape[0]
    out = np.zeros((V, 4, 4), np.float32)

    def proj(v):
        K = Ks[v].copy()
        K[:2] *= scale
        P = np.eye(4, dtype=np.float64)
        P[:3] = K @ w2cs[v][:3]
        return P
    ref_inv = np.linalg.inv(proj(ref))
    for v in range(V):
        out[v] = (proj(v) @ ref_inv).astype(np.float32)
    return out


class MvsPointsInit(nn.Module):
    """MVSNet + premlp. `forward(*args, method=name)` calls the method of
    that name, so `mvs_apply` can run any of them with given variables."""

    def __init__(self, point_features_dim: int = 32, premlp_layers: int = 1,
                 align_corners: bool = True, n_views: int = 3):
        super().__init__()
        self.point_features_dim = point_features_dim
        self.premlp_layers = premlp_layers
        self.align_corners = align_corners
        self.mvsnet = MVSNet(align_corners=align_corners)
        if premlp_layers > 0:
            # input: V x 32 features, color, dir, conf (flax infers it)
            din = 32 * n_views + 7
            self.premlp = nn.ModuleList(
                [nn.Linear(din if i == 0 else point_features_dim,
                           point_features_dim)
                 for i in range(premlp_layers)])

    def forward(self, *args, method: str = "depth_one_view", **kwargs):
        return getattr(self, method)(*args, **kwargs)

    def depth_one_view(self, imgs, proj_mats, depth_values,
                       train: bool = False):
        """imgs [V, 3, H, W] (view 0 the reference), proj_mats [V, 4, 4],
        depth_values [D] -> (depth, conf, features, prob)."""
        return self.mvsnet(imgs, proj_mats, depth_values, train=train)

    def features_only(self, imgs, train: bool = False):
        return self.mvsnet.extract_features(imgs, train)

    def embed_points(self, xyz_world, imgs, feats, Ks, w2cs, campos_ref,
                     conf):
        """xyz_world [N, 3]; imgs [V, 3, H, W]; feats [V, 32, h, w] (1/4
        resolution); Ks [V, 3, 3]; w2cs [V, 4, 4]; campos_ref [3]; conf
        [N, 1]. Returns (embedding [N, F], color [N, 3], dirs [N, 3],
        conf)."""
        V = imgs.shape[0]
        N = xyz_world.shape[0]
        ones = torch.ones((N, 1), device=xyz_world.device)
        xyz_h = torch.cat([xyz_world, ones], -1)
        samples = []
        colors = None
        for v in range(V):
            cam = (xyz_h @ w2cs[v].T)[:, :3]
            z = torch.clamp(cam[:, 2], min=1e-6)
            pix = cam @ Ks[v].T
            x = pix[:, 0] / z
            y = pix[:, 1] / z
            samples.append(bilinear_sample(feats[v], x * 0.25, y * 0.25).T)
            if v == 0:
                colors = bilinear_sample(imgs[v], x, y).T
        feat_cat = torch.cat(samples, -1)                      # [N, V*32]
        dirs = xyz_world - campos_ref[None]
        dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-6)
        if self.premlp_layers > 0:
            x = torch.cat([feat_cat, colors, dirs, conf], -1)
            if x.shape[-1] != self.premlp[0].in_features:
                raise ValueError(
                    f"premlp takes {self.premlp[0].in_features} inputs "
                    f"({(self.premlp[0].in_features - 7) // 32} views); "
                    f"got {x.shape[-1]}")
            for i, lyr in enumerate(self.premlp):
                x = lyr(x)
                if i < len(self.premlp) - 1:
                    # flax's nn.leaky_relu: slope 1 at exactly 0
                    x = torch.where(x >= 0, x, 0.01 * x)
            embedding = x
        else:
            embedding = feat_cat
        return embedding, colors, dirs, conf


def mvs_variables(model: MvsPointsInit) -> Dict[str, Dict[str, torch.Tensor]]:
    """The module's own weights as {"params", "batch_stats"} (detached)."""
    return {"params": {k: v.detach() for k, v in model.named_parameters()},
            "batch_stats": {k: v.detach() for k, v in model.named_buffers()}}


def mvs_apply(model: MvsPointsInit, variables: Dict, *args,
              method: str = "depth_one_view", **kwargs):
    """`method` of `model` run with `variables` in place of its own
    weights. In train mode the BatchNorm writes its running stats into the
    tensors of variables["batch_stats"] (pass copies to keep the old)."""
    tensors = dict(variables["params"])
    tensors.update(variables.get("batch_stats") or {})
    return torch.func.functional_call(model, tensors, args,
                                      dict(kwargs, method=method))


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax's lecun_normal: a normal truncated at +-2 std, std
    sqrt(1 / fan_in) / 0.8796 (the truncated unit normal's spread)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        w.copy_(torch.nn.init.trunc_normal_(
            torch.empty(w.shape), std=std, a=-2 * std, b=2 * std,
            generator=gen).to(w.device))


def init_mvs_points(model: MvsPointsInit,
                    generator: torch.Generator) -> Dict[str, Dict]:
    """The port's seeded initialization with flax's distributions:
    lecun-normal convolution and dense kernels (fan-in over the kernel's
    input axis, for the transposed convolution its output channels, as
    flax's transpose_kernel layout puts them), zero biases, BatchNorm scale
    1 and bias 0, running mean 0 and variance 1. Draws in module order from
    a CPU `generator`; returns `mvs_variables(model)`."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Conv3d)):
            w = mod.weight
            _lecun_normal_(w, w.shape[1] * math.prod(w.shape[2:]), generator)
        elif isinstance(mod, nn.ConvTranspose3d):
            w = mod.weight                      # [in, out, k, k, k]
            _lecun_normal_(w, w.shape[1] * math.prod(w.shape[2:]), generator)
        elif isinstance(mod, nn.Linear):
            _lecun_normal_(mod.weight, mod.in_features, generator)
        elif isinstance(mod, FlaxBatchNorm):
            with torch.no_grad():
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
            continue
        else:
            continue
        if getattr(mod, "bias", None) is not None:
            with torch.no_grad():
                mod.bias.zero_()
    return mvs_variables(model)


def load_pretrained_mvsnet(variables: Dict, ckpt_path: str,
                           model: Optional[MvsPointsInit] = None) -> Dict:
    """`variables` with its MVSNet part replaced by a converted reference
    checkpoint (mvs/torch_import.py); the premlp keeps its fresh init. The
    checkpoint wants MvsPointsInit(align_corners=False), the as-run
    grid_sample semantics it was evaluated with: pass `model` to have
    that checked."""
    from .torch_import import load_mvsnet_checkpoint

    if model is not None and model.align_corners:
        raise ValueError(
            "imported torch checkpoints require "
            "MvsPointsInit(align_corners=False); this model was built with "
            "align_corners=True")
    conv = load_mvsnet_checkpoint(ckpt_path)
    dev = next(iter(variables["params"].values())).device
    out = {"params": dict(variables["params"]),
           "batch_stats": dict(variables.get("batch_stats") or {})}
    for group in ("params", "batch_stats"):
        for k, v in conv[group].items():
            key = "mvsnet." + k
            if key not in out[group]:
                raise KeyError(f"checkpoint entry {k} has no place in the "
                               "model")
            out[group][key] = v.to(dev)
    return out


def images_nchw(images: np.ndarray, device) -> torch.Tensor:
    """[V, H, W, 3] numpy -> [V, 3, H, W] float32 tensor on `device`."""
    return torch.as_tensor(np.ascontiguousarray(
        np.asarray(images, np.float32).transpose(0, 3, 1, 2)), device=device)


@torch.no_grad()
def gen_scene_points(params, model: MvsPointsInit, images: np.ndarray,
                     Ks: np.ndarray, w2cs: np.ndarray,
                     near_far: Tuple[float, float], n_depths: int = 128,
                     depth_conf_thresh: float = 0.8, geo_cnsst_num: int = 3,
                     batch_stats=None) -> Dict[str, np.ndarray]:
    """The init pipeline over all views: each view as the reference in
    turn (the others after it in order), the filter, then the payloads.
    images [V, H, W, 3] in [0, 1] (numpy); Ks [V, 3, 3]; w2cs [V, 4, 4].
    Runs on the device of `params`. Returns numpy xyz, embedding, color,
    dirs, conf."""
    dev = next(iter(params.values())).device
    V, H, W, _ = images.shape
    depth_values = np.linspace(near_far[0], near_far[1], n_depths,
                               dtype=np.float32)
    variables = {"params": params, "batch_stats": batch_stats or {}}
    imgs_t = images_nchw(images, dev)
    dv = torch.as_tensor(depth_values, device=dev)
    depths, confs, K4 = [], [], []
    feats_per_view = None
    for ref in range(V):
        order = [ref] + [v for v in range(V) if v != ref]
        projs = torch.as_tensor(view_proj_mats(Ks, w2cs, ref)[order],
                                device=dev)
        d, c, feats, _prob = mvs_apply(model, variables, imgs_t[order],
                                       projs, dv, method="depth_one_view")
        depths.append(d)
        confs.append(c)
        if ref == 0:
            # the features come back in `order`; keep view 0's ordering
            feats_per_view = feats[torch.as_tensor(np.argsort(order),
                                                   device=dev)]
        K4.append(Ks[ref].copy())
    h = depths[0].shape[0]
    Ks_quarter = []
    for K in K4:
        Kq = K.copy()
        Kq[:2] *= (h / H)
        Ks_quarter.append(Kq)
    xyz_lst, conf_lst = filter_by_masks(
        depths, confs, Ks_quarter, [w2cs[v] for v in range(V)],
        depth_conf_thresh=depth_conf_thresh, geo_cnsst_num=geo_cnsst_num,
        device=dev)
    xyz = np.concatenate(xyz_lst) if xyz_lst else np.zeros((0, 3), np.float32)
    conf = (np.concatenate(conf_lst)[:, None] if conf_lst
            else np.zeros((0, 1), np.float32))
    if xyz.shape[0] == 0:
        F_ = model.point_features_dim
        return {"xyz": xyz, "embedding": np.zeros((0, F_), np.float32),
                "color": np.zeros((0, 3), np.float32),
                "dirs": np.zeros((0, 3), np.float32), "conf": conf}
    campos_ref = np.linalg.inv(w2cs[0])[:3, 3]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    emb, color, dirs, _conf = mvs_apply(
        model, variables, t(xyz), imgs_t, feats_per_view, t(Ks), t(w2cs),
        t(campos_ref), t(conf), method="embed_points")
    return {"xyz": xyz, "embedding": emb.cpu().numpy(),
            "color": color.cpu().numpy(), "dirs": dirs.cpu().numpy(),
            "conf": conf}


def new_mvs_model(point_features_dim: int = 32, n_views: int = 3,
                  align_corners: bool = True,
                  device: DeviceLike = None) -> MvsPointsInit:
    """An MvsPointsInit on `device` (the card unless asked otherwise)."""
    return MvsPointsInit(point_features_dim=point_features_dim,
                         align_corners=align_corners,
                         n_views=n_views).to(resolve_device(device))
