"""2D neural-render heads: a GIRAFFE-style CNN and a StyleGAN2 generator and
discriminator, decoding the point renderer's feature image to RGB.

Counterpart of `pointnerf_tpu/models/neural_render.py`: `_blur`,
`upsample2x`, `NeuralRenderer`, `EqualLinear`, `StyleVectorizer`,
`Conv2DMod`, `RGBBlock`, `GeneratorBlock`, `Generator`,
`DiscriminatorBlock` and `Discriminator`, with JAX's names and constructor
arguments. PyTorch builds its layers eagerly, so a block that flax sizes
from its first input takes that width as an argument (`input_channels`);
the top-level modules read it from their own arguments (the CNN's input
has `input_dim` channels, the generator's feature image `init_channels`,
z `emb`, images 3). Inside, tensors are NCHW; each module's submodules
carry flax's automatic names (`Conv_0`, `Dense_1`,
`GeneratorBlock_0`, ...), so a flax parameter path is the state_dict key
(`convert.neural_render_from_flax`). Conv2DMod's per-sample weights are one
grouped convolution over the batch (groups = B). flax's "SAME" padding is
symmetric for the stride-1 convolutions and is written out with `F.pad`
for the stride-2 one, where it pads (0, 1) on an even input. The
convolutions are cuDNN's on the card; the callers run them in float32
(TF32 off, `mvs.mvsnet.mvs_precision`).

`init_neural_render(module, generator)` draws flax's initializers from an
explicit generator and returns the parameters as {name: tensor};
`apply_head(module, params, *args)` runs a module with them.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn
import torch.nn.functional as F

GN_EPS = 1e-6      # flax GroupNorm's epsilon (torch's default is 1e-5)


def _blur(x: torch.Tensor) -> torch.Tensor:
    """Binomial [1,2,1]^2 blur, depthwise, zero padding (NCHW)."""
    k1 = torch.tensor([1.0, 2.0, 1.0], dtype=x.dtype, device=x.device)
    k = k1[:, None] * k1[None, :]
    k = k / k.sum()
    C = x.shape[1]
    return F.conv2d(x, k.expand(C, 1, 3, 3), padding=1, groups=C)


def upsample2x(x: torch.Tensor, method: str = "bilinear",
               blur: bool = True) -> torch.Tensor:
    """2x upsample: half-pixel bilinear (jax.image.resize's, edges
    clamped) then the blur, or nearest."""
    if method == "nn":
        return F.interpolate(x, scale_factor=2, mode="nearest")
    out = F.interpolate(x, scale_factor=2, mode="bilinear",
                        align_corners=False)
    return _blur(out) if blur else out


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax/XLA "SAME" padding of a k x k, stride-s convolution: output
    ceil(n / s), the padding's odd pixel at the high end."""
    pads = []
    for n in (x.shape[3], x.shape[2]):                 # W, then H
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    """flax nn.Conv(cout, (k, k)): SAME padding at stride 1 (symmetric for
    odd k); a stride-2 caller pads with `_same_pad`."""
    return nn.Conv2d(cin, cout, k, stride=stride,
                     padding=k // 2 if stride == 1 else 0)


def _lrelu(x):
    """jax.nn.leaky_relu(x, 0.2): its slope at exactly 0 is 1, where
    F.leaky_relu's is 0.2. A miss ray's feature pixel is 0, so before its
    bias first moves a convolution's output there is exactly 0."""
    return torch.where(x >= 0, x, 0.2 * x)


class NeuralRenderer(nn.Module):
    """GIRAFFE-style CNN decoder (blocks keep the input resolution, the RGB
    skip accumulates per block, final sigmoid). forward: [B, input_dim, H,
    W] -> [B, out_dim, H, W]."""

    def __init__(self, n_feat: int = 128, input_dim: int = 131,
                 out_dim: int = 3, final_actvn: bool = True,
                 min_feat: int = 32, img_size: int = 64,
                 use_rgb_skip: bool = True, use_norm: bool = False):
        super().__init__()
        self.final_actvn, self.use_rgb_skip = final_actvn, use_rgb_skip
        self.use_norm = use_norm
        n_blocks = int(math.log2(img_size) - 4)
        self.widths = [n_feat // 2] + [
            max(n_feat // (2 ** (i + 2)), min_feat)
            for i in range(n_blocks - 1)]
        # flax's names, in its order of creation
        names = {"Conv": 0, "GroupNorm": 0}

        def add(kind, mod):
            name = f"{kind}_{names[kind]}"
            names[kind] += 1
            self.add_module(name, mod)
            return name
        self.conv_in = (None if n_feat == input_dim
                        else add("Conv", _conv(input_dim, n_feat, 1)))
        self.rgb_in = (add("Conv", _conv(input_dim, out_dim, 3))
                       if use_rgb_skip else None)
        self.blocks = []
        prev = n_feat
        for w in self.widths:
            hid = add("Conv", _conv(prev, w, 3))
            norm = add("GroupNorm", nn.GroupNorm(w, w, eps=GN_EPS)) \
                if use_norm else None
            rgb = add("Conv", _conv(w, out_dim, 3)) if use_rgb_skip else None
            self.blocks.append((hid, norm, rgb))
            prev = w
        self.rgb_out = (None if use_rgb_skip
                        else add("Conv", _conv(prev, out_dim, 1)))

    def forward(self, x):
        net = x if self.conv_in is None else getattr(self, self.conv_in)(x)
        rgb = getattr(self, self.rgb_in)(x) if self.use_rgb_skip else None
        for hid, norm, rgb_conv in self.blocks:
            h = getattr(self, hid)(net)
            if norm is not None:
                h = getattr(self, norm)(h)
            net = _lrelu(h)
            if rgb_conv is not None:
                rgb = rgb + getattr(self, rgb_conv)(net)
        if not self.use_rgb_skip:
            rgb = getattr(self, self.rgb_out)(net)
        return torch.sigmoid(rgb) if self.final_actvn else rgb


# ---------------------------------------------------------------------------
# StyleGAN2
# ---------------------------------------------------------------------------

class EqualLinear(nn.Module):
    """x @ (weight * lr_mul) + bias * lr_mul; `weight` is flax's [in, out]
    raw weight (lr_mul applied in forward)."""

    def __init__(self, dim_in: int, dim_out: int, lr_mul: float = 0.1):
        super().__init__()
        self.lr_mul = lr_mul
        self.weight = nn.Parameter(torch.empty(dim_in, dim_out))
        self.bias = nn.Parameter(torch.zeros(dim_out))

    def forward(self, x):
        return x @ (self.weight * self.lr_mul) + self.bias * self.lr_mul


class StyleVectorizer(nn.Module):
    """z [B, emb] -> w mapping network: z / (|z| + 1e-8), then `depth`
    EqualLinear + leaky ReLU layers of width `emb`."""

    def __init__(self, emb: int, depth: int, lr_mul: float = 0.1):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"EqualLinear_{i}", EqualLinear(emb, emb, lr_mul))

    def forward(self, z):
        x = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-8)
        for i in range(self.depth):
            x = _lrelu(getattr(self, f"EqualLinear_{i}")(x))
        return x


class Conv2DMod(nn.Module):
    """Modulated convolution: per sample the weight W * (style + 1) over the
    input channels, demodulated by rsqrt(sum over (in, kh, kw) + 1e-8) per
    output channel when `demod`. `weight` is [out, in, k, k] (flax's HWIO
    kernel transposed); x [B, in, H, W], style [B, in]."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 demod: bool = True):
        super().__init__()
        self.kernel, self.demod = kernel, demod
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))

    def forward(self, x, style):
        B, cin, H, W = x.shape
        w = self.weight[None] * (style + 1.0)[:, None, :, None, None]
        if self.demod:
            w = w * torch.rsqrt((w * w).sum((2, 3, 4), keepdim=True) + 1e-8)
        out = F.conv2d(x.reshape(1, B * cin, H, W),
                       w.reshape(-1, cin, self.kernel, self.kernel),
                       padding=self.kernel // 2, groups=B)
        return out.reshape(B, -1, H, W)


class RGBBlock(nn.Module):
    def __init__(self, latent_dim: int, input_channels: int, upsample: bool):
        super().__init__()
        self.upsample = upsample
        self.Dense_0 = nn.Linear(latent_dim, input_channels)
        self.Conv2DMod_0 = Conv2DMod(input_channels, 3, kernel=1, demod=False)

    def forward(self, x, prev_rgb, istyle):
        rgb = self.Conv2DMod_0(x, self.Dense_0(istyle))
        if prev_rgb is not None:
            rgb = rgb + prev_rgb
        return upsample2x(rgb, "bilinear") if self.upsample else rgb


class GeneratorBlock(nn.Module):
    def __init__(self, latent_dim: int, input_channels: int, filters: int,
                 upsample: bool = True, upsample_rgb: bool = True):
        super().__init__()
        self.upsample = upsample
        self.Dense_0 = nn.Linear(latent_dim, input_channels)
        self.Conv2DMod_0 = Conv2DMod(input_channels, filters, 3)
        self.Dense_1 = nn.Linear(latent_dim, filters)
        self.Conv2DMod_1 = Conv2DMod(filters, filters, 3)
        self.RGBBlock_0 = RGBBlock(latent_dim, filters, upsample_rgb)

    def forward(self, x, prev_rgb, istyle):
        if self.upsample:
            x = upsample2x(x, "bilinear", blur=False)
        x = _lrelu(self.Conv2DMod_0(x, self.Dense_0(istyle)))
        x = _lrelu(self.Conv2DMod_1(x, self.Dense_1(istyle)))
        return x, self.RGBBlock_0(x, prev_rgb, istyle)


class Generator(nn.Module):
    """StyleGAN2 generator seeded by the point-rendered feature image.
    forward(styles [B, num_layers, latent_dim], initial [B, init_channels,
    h, w]) -> rgb [B, 3, h * 2^(num_layers-1), ...]."""

    def __init__(self, image_size: int, latent_dim: int,
                 network_capacity: int = 16, fmap_max: int = 512,
                 init_channels: int = 128):
        super().__init__()
        self.num_layers = int(math.log2(image_size) - 6)
        filters = [min(network_capacity * (2 ** (i + 1)), fmap_max)
                   for i in range(self.num_layers)][::-1]
        self.Conv_0 = _conv(init_channels, init_channels, 3)
        prev = init_channels
        for ind, f in enumerate(filters):
            self.add_module(f"GeneratorBlock_{ind}", GeneratorBlock(
                latent_dim, prev, f, upsample=ind != 0,
                upsample_rgb=ind != self.num_layers - 1))
            prev = f

    def forward(self, styles, initial):
        x = self.Conv_0(initial)
        rgb = None
        for ind in range(self.num_layers):
            x, rgb = getattr(self, f"GeneratorBlock_{ind}")(x, rgb,
                                                           styles[:, ind])
        return rgb


class DiscriminatorBlock(nn.Module):
    def __init__(self, input_channels: int, filters: int,
                 downsample: bool = True):
        super().__init__()
        self.downsample = downsample
        self.Conv_0 = _conv(input_channels, filters, 1,
                            stride=2 if downsample else 1)
        self.Conv_1 = _conv(input_channels, filters, 3)
        self.Conv_2 = _conv(filters, filters, 3)
        if downsample:
            self.Conv_3 = _conv(filters, filters, 3, stride=2)

    def forward(self, x):
        res = self.Conv_0(x)
        h = _lrelu(self.Conv_1(x))
        h = _lrelu(self.Conv_2(h))
        if self.downsample:
            h = self.Conv_3(_same_pad(_blur(h), 3, 2))
        return (h + res) * (1.0 / math.sqrt(2.0))


class Discriminator(nn.Module):
    """A logit per image [B, 3, image_size, image_size] -> [B]. The last
    block's map is flattened in flax's (H, W, C) order."""

    def __init__(self, image_size: int, network_capacity: int = 16,
                 fmap_max: int = 512):
        super().__init__()
        self.num_layers = int(math.log2(image_size) - 1)
        prev, side = 3, image_size
        for i in range(self.num_layers):
            f = min(network_capacity * (2 ** (i + 1)), fmap_max)
            down = i != self.num_layers - 1
            self.add_module(f"DiscriminatorBlock_{i}",
                            DiscriminatorBlock(prev, f, downsample=down))
            prev, side = f, (-(-side // 2) if down else side)
        self.Dense_0 = nn.Linear(side * side * prev, 1)

    def forward(self, img):
        x = img
        for i in range(self.num_layers):
            x = getattr(self, f"DiscriminatorBlock_{i}")(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.Dense_0(x)[:, 0]


def _trunc_normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    """flax's truncated-normal variance scaling: a unit normal cut at +-2,
    scaled so its spread is `std`."""
    s = std / 0.87962566103423978
    return torch.nn.init.trunc_normal_(torch.empty(shape), std=s, a=-2 * s,
                                       b=2 * s, generator=gen)


def init_neural_render(module: nn.Module, generator: torch.Generator,
                       device=None) -> Dict[str, torch.Tensor]:
    """The port's seeded initialization with flax's distributions, drawn in
    module order from a CPU `generator`: lecun-normal Conv and Dense
    kernels, zero biases; EqualLinear weights unit normal; Conv2DMod
    weights He-style (variance 2 / (1 + 0.2^2) over the fan-in) truncated
    normal; GroupNorm scale 1, bias 0. The module is moved to `device` (by
    default where its parameters are); returns {name: tensor}."""
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                w = mod.weight
                fan_in = w.shape[1] * math.prod(w.shape[2:])
                w.copy_(_trunc_normal(w.shape, math.sqrt(1.0 / fan_in),
                                      generator))
                mod.bias.zero_()
            elif isinstance(mod, EqualLinear):
                mod.weight.copy_(torch.randn(mod.weight.shape,
                                             generator=generator))
                mod.bias.zero_()
            elif isinstance(mod, Conv2DMod):
                w = mod.weight
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
                w.copy_(_trunc_normal(w.shape, math.sqrt(
                    2.0 / (1 + 0.2 ** 2) / fan_in), generator))
            elif isinstance(mod, nn.GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
    if device is not None:
        module.to(device)
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def apply_head(module: nn.Module, params: Dict[str, torch.Tensor], *args):
    """`module(*args)` with `params` ({name: tensor}) in place of its own
    weights (gradients flow into `params`)."""
    return torch.func.functional_call(module, params, args)
