"""Feature rendering and 2D neural-render head training.

Counterpart of `pointnerf_tpu/train/neural2d.py`: `Neural2DState`,
`make_neural2d_optimizer`, `make_neural2d_step`, `create_neural2d_state`,
`diff_augment`, `hinge_d_loss`, `hinge_g_loss`, `gradient_penalty`,
`GANTrainState`, `make_gan_step` and `create_gan_state`. A step renders a
square patch of rays through the point pipeline at C feature channels
(zero background), lays the [R, C] colors out as a [1, C, P, P] image in
the rays' row-major order, decodes it to RGB with a CNN head
(`NeuralRenderer`) or a StyleGAN2 generator conditioned on a per-frame
style code, and backpropagates the RGB loss into the head, the aggregator
and the point payloads. The adversarial step updates a discriminator
(hinge loss on DiffAugmented images, a gradient penalty every `gp_every`
steps), then the generator side against the new discriminator, then an
EMA of the head.

The heads' parameters are {name: tensor} dicts run through
`models.neural_render.apply_head`; their convolutions run in float32 (TF32
off, `mvs_precision`) forward and backward. The Adam groups ("mlp",
"points", "head", "style", "stylevec": one state and count each, as JAX's
`multi_transform`) are `train/optim.adam_update`. Random draws come from
the state's generator unless given: the render jitter as `u` [R, D] (the
GAN step's two renders as draws["render"] and draws["render2"]) and the
augmentations as draws["aug_d"] / draws["aug_g"] (`augment_draws`), so
tests can pass JAX's.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..config import PointNeRFConfig
from ..models.losses import mse2psnr
from ..models.neural_render import (Discriminator, Generator, NeuralRenderer,
                                    StyleVectorizer, apply_head)
from ..models.points import PointCloud, PointCloudStatic
from ..models.renderer import RayBatch, render_rays
from ..mvs.mvsnet import mvs_precision
from ..ops.grid import PointGrid
from .optim import (AdamState, adam_update, freeze_points, init_optimizer,
                    lr_schedule, tree_leaves, tree_map)

D_B1, D_B2 = 0.5, 0.9          # the discriminator's Adam betas


class Neural2DState(NamedTuple):
    # {"mlp", "points", "head"[, "style", "stylevec"]}
    params: Dict[str, Any]
    opt_state: Dict[str, AdamState]
    step: torch.Tensor             # [] int32
    key: torch.Generator           # draws the render jitter


def make_neural2d_optimizer(cfg: PointNeRFConfig) -> Dict[str, Any]:
    """Each group's learning rate (or schedule): the points at plr, every
    other group at lr, on the config's schedule."""
    lr = lr_schedule(cfg.train.lr, cfg)
    return {"mlp": lr, "points": lr_schedule(cfg.train.plr, cfg),
            "head": lr, "style": lr, "stylevec": lr}


def _group_adam(grads, opt_state: Dict[str, AdamState], lrs):
    """One Adam step for each group present: (updates, new state)."""
    updates, new_opt = {}, {}
    for g in grads:
        updates[g], new_opt[g] = adam_update(grads[g], opt_state[g], lrs[g])
    return updates, new_opt


def _value_and_grad(fn: Callable, params) -> Tuple[torch.Tensor, Dict, Any]:
    """(total, items, grads) of `fn(params) -> (total, items)`, the
    gradients in the layout of `params` (zeros where none flows)."""
    if torch.is_inference_mode_enabled():
        raise RuntimeError("training needs autograd: do not call it under "
                           "torch.inference_mode")
    params = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad(), mvs_precision():
        total, items = fn(params)
        leaves = tree_leaves(params)
        gl = torch.autograd.grad(total, leaves, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, gl)])
    items = {k: v.detach() for k, v in items.items()}
    return total.detach(), items, tree_map(lambda _p: next(it), params)


def make_gen_rgb(cfg: PointNeRFConfig, head: Optional[NeuralRenderer],
                 patch: int, generator: Optional[Generator] = None,
                 vectorizer: Optional[StyleVectorizer] = None):
    """gen_rgb(params, st, grid, batch, frame_id, key, u) -> [1, 3, P, P]:
    the training render of the patch's rays (jitter `u`, else drawn from
    `key`) as a feature image, decoded by the head; with `generator` the
    StyleGAN2 path (the frame's style code through the vectorizer, the
    same style for every layer)."""
    C = cfg.agg.shading_color_channel_num

    def gen_rgb(params, st, grid, batch, frame_id, key, u=None):
        out = render_rays(params["mlp"],
                          freeze_points(params["points"], cfg.points),
                          st, grid, batch, cfg, train=True, generator=key,
                          u=u)
        feat_img = out.coarse_raycolor.reshape(1, patch, patch, C).permute(
            0, 3, 1, 2)
        if generator is not None:
            z = params["style"][int(frame_id)]
            w = apply_head(vectorizer, params["stylevec"], z[None])
            styles = w[:, None, :].expand(-1, generator.num_layers, -1)
            return apply_head(generator, params["head"], styles, feat_img)
        return apply_head(head, params["head"], feat_img)
    return gen_rgb


def _hwc(rgb: torch.Tensor) -> torch.Tensor:
    """[1, 3, P, P] -> [P, P, 3]."""
    return rgb[0].permute(1, 2, 0)


def make_neural2d_step(cfg: PointNeRFConfig, head: Optional[NeuralRenderer],
                       patch: int, generator: Optional[Generator] = None,
                       vectorizer: Optional[StyleVectorizer] = None):
    """step(state, st, grid, batch, gt_rgb [P, P, 3], frame_id, u=None) ->
    (state, items): `patch`^2 rays (random_sample_size), the RGB MSE, one
    Adam step of every group. With `generator` / `vectorizer` the StyleGAN2
    path (params["style"][frame_id] conditions each layer); else `head`."""
    lrs = make_neural2d_optimizer(cfg)
    gen_rgb = make_gen_rgb(cfg, head, patch, generator, vectorizer)

    def step(state: Neural2DState, st: PointCloudStatic, grid: PointGrid,
             batch: RayBatch, gt_rgb: torch.Tensor, frame_id,
             u: Optional[torch.Tensor] = None):
        def loss_fn(params):
            rgb = gen_rgb(params, st, grid, batch, frame_id, state.key, u)
            loss = ((_hwc(rgb) - gt_rgb) ** 2).mean()
            return loss, {"loss_total": loss, "psnr": mse2psnr(loss)}
        _t, items, grads = _value_and_grad(loss_fn, state.params)
        with torch.no_grad():
            updates, new_opt = _group_adam(grads, state.opt_state, lrs)
            new_params = tree_map(lambda p, du: p + du, state.params,
                                  updates)
        return Neural2DState(params=new_params, opt_state=new_opt,
                             step=state.step + 1, key=state.key), items

    return step


def create_neural2d_state(generator: torch.Generator, agg_params,
                          pc: PointCloud, head_params,
                          style_codes: Optional[torch.Tensor] = None,
                          stylevec_params=None) -> Neural2DState:
    """Step-0 state; `style_codes` [n_frames, z_dim] and `stylevec_params`
    for the StyleGAN2 path. `generator` draws the jitter on the device of
    the batches."""
    params = {"mlp": agg_params, "points": pc, "head": head_params}
    if style_codes is not None:
        params["style"] = style_codes
        params["stylevec"] = stylevec_params
    return Neural2DState(params=params,
                         opt_state=init_optimizer(params, tuple(params)),
                         step=torch.zeros((), dtype=torch.int32,
                                          device=pc.xyz.device),
                         key=generator)


# --------------------------------------------------------------------------
# Adversarial training
# --------------------------------------------------------------------------

def augment_draws(generator: torch.Generator, H: int, W: int,
                  prob: float) -> Dict[str, int]:
    """diff_augment's random draws from `generator` (one read back to the
    host): on (with probability `prob`), flip (1/2), the translation tx, ty
    in [0, 2s] (s = max(H // 8, 1)) and the cutout corner cx in [0, W - ch],
    cy in [0, H - ch] (ch = max(H // 2, 1))."""
    s, ch = max(H // 8, 1), max(H // 2, 1)
    u = torch.rand(6, generator=generator,
                   device=generator.device).tolist()
    return {"on": int(u[0] < prob), "flip": int(u[1] < 0.5),
            "tx": int(u[2] * (2 * s + 1)), "ty": int(u[3] * (2 * s + 1)),
            "cx": int(u[4] * (W - ch + 1)), "cy": int(u[5] * (H - ch + 1))}


def diff_augment(imgs: torch.Tensor, draws: Dict[str, int]) -> torch.Tensor:
    """Differentiable augmentation before the discriminator, imgs [B, C, H,
    W] in [0, 1]: when draws["on"], a horizontal flip (draws["flip"]), a
    translation by (tx - s, ty - s) with zero fill, then a cutout of an
    H/2 x W/2 square at (cx, cy) (`augment_draws`)."""
    if not draws["on"]:
        return imgs
    B, C, H, W = imgs.shape
    if draws["flip"]:
        imgs = imgs.flip(3)
    s, ch = max(H // 8, 1), max(H // 2, 1)
    padded = torch.nn.functional.pad(imgs, (s, s, s, s))
    ty, tx = draws["ty"], draws["tx"]
    imgs = padded[:, :, ty:ty + H, tx:tx + W]
    yy = torch.arange(H, device=imgs.device)[:, None]
    xx = torch.arange(W, device=imgs.device)[None, :]
    cx, cy = draws["cx"], draws["cy"]
    hole = (yy >= cy) & (yy < cy + ch) & (xx >= cx) & (xx < cx + ch)
    return imgs * (1.0 - hole.to(imgs.dtype))


def hinge_d_loss(real_logits, fake_logits):
    """D objective, with the reference's sign convention: D pushes real
    logits <= -1 and fake logits >= +1."""
    return torch.relu(1.0 + real_logits).mean() + \
        torch.relu(1.0 - fake_logits).mean()


def hinge_g_loss(fake_logits):
    """G objective: minimize the fake logit."""
    return fake_logits.mean()


def gradient_penalty(d_apply, d_params, images, weight: float = 10.0):
    """weight * mean((|d sum D(images) / d images| - 1)^2), the norm
    sqrt(sum g^2 + 1e-12) per image; differentiable in `d_params` (a double
    backward)."""
    images = images.detach().requires_grad_()
    g, = torch.autograd.grad(d_apply(d_params, images).sum(), images,
                             create_graph=True)
    norms = torch.sqrt((g.reshape(g.shape[0], -1) ** 2).sum(-1) + 1e-12)
    return weight * ((norms - 1.0) ** 2).mean()


class GANTrainState(NamedTuple):
    params: Dict[str, Any]         # the generator side, as Neural2DState's
    g_opt_state: Dict[str, AdamState]
    d_params: Dict[str, torch.Tensor]
    d_opt_state: AdamState
    ema: Dict[str, Any]            # EMA copies of {"head"[, "stylevec"]}
    step: torch.Tensor             # [] int32
    key: torch.Generator           # draws the jitter and the augmentations


def make_gan_step(cfg: PointNeRFConfig, head: Optional[NeuralRenderer],
                  patch: int, disc: Discriminator,
                  generator: Optional[Generator] = None,
                  vectorizer: Optional[StyleVectorizer] = None,
                  recon_weight: float = 1.0, gan_weight: float = 1.0,
                  aug_prob: float = 0.5, gp_every: int = 4,
                  gp_weight: float = 10.0, ema_beta: float = 0.995,
                  d_lr: float = 2e-4):
    """step(state, st, grid, batch, gt_rgb [P, P, 3], frame_id, draws=None)
    -> (state, items), in the reference's order: the fake rendered without
    gradient (draws["render"]); the D hinge update on DiffAugmented fake
    and real (the same draws["aug_d"] for both) plus the gradient penalty
    on the real image when step % gp_every == 0, Adam(d_lr, 0.5, 0.9); the
    second render (draws["render2"]) and the G loss, recon_weight * MSE +
    gan_weight * hinge against the new D (draws["aug_g"]); the G Adam step
    of every group; the EMA of the head (and the vectorizer) from step 0.
    Missing draws come from the state's generator, in the order render,
    aug_d, aug_g, render2."""
    lrs = make_neural2d_optimizer(cfg)
    gen_rgb = make_gen_rgb(cfg, head, patch, generator, vectorizer)

    def d_apply(d_params, img):
        return apply_head(disc, d_params, img)

    def step(state: GANTrainState, st: PointCloudStatic, grid: PointGrid,
             batch: RayBatch, gt_rgb: torch.Tensor, frame_id,
             draws: Optional[Dict[str, Any]] = None):
        draws = draws or {}
        key = state.key
        with torch.no_grad(), mvs_precision():
            fake = gen_rgb(state.params, st, grid, batch, frame_id, key,
                           draws.get("render"))
        real = gt_rgb.permute(2, 0, 1)[None]
        aug_d = draws.get("aug_d") or augment_draws(key, patch, patch,
                                                    aug_prob)
        gp_on = int(state.step) % gp_every == 0

        def d_loss_fn(d_params):
            f_log = d_apply(d_params, diff_augment(fake, aug_d))
            r_log = d_apply(d_params, diff_augment(real, aug_d))
            div = hinge_d_loss(r_log, f_log)
            gp = (gradient_penalty(d_apply, d_params, real, gp_weight)
                  if gp_on else torch.zeros((), device=real.device))
            return div + gp, {"loss_d": div, "loss_gp": gp}
        _d_total, d_items, d_grads = _value_and_grad(d_loss_fn,
                                                     state.d_params)
        with torch.no_grad():
            d_updates, new_d_opt = adam_update(d_grads, state.d_opt_state,
                                               d_lr, D_B1, D_B2)
            new_d = tree_map(lambda p, du: p + du, state.d_params, d_updates)

        aug_g = draws.get("aug_g") or augment_draws(key, patch, patch,
                                                    aug_prob)

        def g_loss_fn(params):
            rgb = gen_rgb(params, st, grid, batch, frame_id, key,
                          draws.get("render2"))
            recon = ((_hwc(rgb) - gt_rgb) ** 2).mean()
            adv = hinge_g_loss(d_apply(new_d, diff_augment(rgb, aug_g)))
            total = recon_weight * recon + gan_weight * adv
            return total, {"loss_total": total, "loss_recon": recon,
                           "loss_g_adv": adv}
        _g_total, items, g_grads = _value_and_grad(g_loss_fn, state.params)
        with torch.no_grad():
            g_updates, new_g_opt = _group_adam(g_grads, state.g_opt_state,
                                               lrs)
            new_params = tree_map(lambda p, du: p + du, state.params,
                                  g_updates)
            new_ema = {k: tree_map(lambda e, p: ema_beta * e
                                   + (1 - ema_beta) * p, state.ema[k],
                                   new_params[k]) for k in state.ema}
        items.update(d_items)
        items["psnr"] = mse2psnr(items["loss_recon"])
        return GANTrainState(params=new_params, g_opt_state=new_g_opt,
                             d_params=new_d, d_opt_state=new_d_opt,
                             ema=new_ema, step=state.step + 1,
                             key=state.key), items

    return step


def create_gan_state(generator: torch.Generator, agg_params, pc: PointCloud,
                     head_params, d_params,
                     style_codes: Optional[torch.Tensor] = None,
                     stylevec_params=None) -> GANTrainState:
    """Step-0 state; the EMA starts as a copy of the head (and the
    vectorizer)."""
    params = {"mlp": agg_params, "points": pc, "head": head_params}
    ema = {"head": tree_map(torch.clone, head_params)}
    if style_codes is not None:
        params["style"] = style_codes
        params["stylevec"] = stylevec_params
        ema["stylevec"] = tree_map(torch.clone, stylevec_params)
    return GANTrainState(
        params=params, g_opt_state=init_optimizer(params, tuple(params)),
        d_params=d_params,
        d_opt_state=init_optimizer({"d": d_params}, ("d",))["d"], ema=ema,
        step=torch.zeros((), dtype=torch.int32, device=pc.xyz.device),
        key=generator)
