"""MVSNet depth estimation in PyTorch's layouts (NCHW / NCDHW).

Counterpart of `pointnerf_tpu/mvs/mvsnet.py` (`ConvBnReLU`, `ConvBnReLU3D`,
`DeconvBnReLU3D`, `FeatureNet`, `CostRegNet`, `homo_warp`,
`depth_regression`, `MVSNet`): FeatureNet (3 -> 32 channels at 1/4
resolution) -> plane-sweep homography warp -> variance cost volume over the
views -> CostRegNet 3D UNet -> softmax over depth -> soft-argmax depth and
the 4-bin photometric confidence.

The convolutions are `nn.Conv2d` / `nn.Conv3d` / `nn.ConvTranspose3d` on
cuDNN, run in float32: `mvs_precision()` switches cuDNN's TF32 off around
them (the caller wraps a backward in it too), without touching the global
flag. The BatchNorm is flax's (`FlaxBatchNorm`), not torch's: statistics
over every axis but the channel one of the one tensor it sees (each view's
FeatureNet pass alone), the biased variance E[x^2] - E[x]^2 clipped at 0,
running stats ra = 0.99 ra + 0.01 batch, eps 1e-5. Submodule names follow
JAX's, which are the reference's torch attribute names.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.sample2d import bilinear_sample

BN_MOMENTUM = 0.99
BN_EPS = 1e-5


@contextlib.contextmanager
def mvs_precision():
    """cuDNN convolutions in full float32 (TF32 off) inside the block; the
    other cuDNN settings stay as they are."""
    cd = torch.backends.cudnn
    with cd.flags(enabled=cd.enabled, benchmark=cd.benchmark,
                  deterministic=cd.deterministic, allow_tf32=False):
        yield


class FlaxBatchNorm(nn.Module):
    """flax.linen.BatchNorm over a [N, C, ...] tensor: `weight` is flax's
    scale, the buffers its batch_stats (mean, var). In train mode it
    normalizes with the statistics of this tensor (over every axis but C)
    and folds them into the running buffers in place; otherwise it uses
    the running buffers."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if train:
            dims = [0] + list(range(2, x.dim()))
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                        + (1 - BN_MOMENTUM) * mean)
                self.running_var.copy_(BN_MOMENTUM * self.running_var
                                       + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class ConvBnReLU(nn.Module):
    """Conv2d(bias=False) + BN + ReLU, padding k//2 on each side."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                              padding=kernel // 2, bias=False)
        self.bn = FlaxBatchNorm(out_ch)

    def forward(self, x, train: bool = False):
        return F.relu(self.bn(self.conv(x), train))


class ConvBnReLU3D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.conv = nn.Conv3d(in_ch, out_ch, kernel, stride=stride,
                              padding=kernel // 2, bias=False)
        self.bn = FlaxBatchNorm(out_ch)

    def forward(self, x, train: bool = False):
        return F.relu(self.bn(self.conv(x), train))


class DeconvBnReLU3D(nn.Module):
    """ConvTranspose3d(k=3, s=2, padding=1, output_padding=1, bias=False) +
    BN + ReLU: flax's ConvTranspose(padding=(1, 2), transpose_kernel=True)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.deconv = nn.ConvTranspose3d(in_ch, out_ch, 3, stride=2,
                                         padding=1, output_padding=1,
                                         bias=False)
        self.bn = FlaxBatchNorm(out_ch)

    def forward(self, x, train: bool = False):
        return F.relu(self.bn(self.deconv(x), train))


class FeatureNet(nn.Module):
    """[N, 3, H, W] -> [N, 32, H/4, W/4]."""

    def __init__(self):
        super().__init__()
        self.conv0 = ConvBnReLU(3, 8)
        self.conv1 = ConvBnReLU(8, 8)
        self.conv2 = ConvBnReLU(8, 16, kernel=5, stride=2)
        self.conv3 = ConvBnReLU(16, 16)
        self.conv4 = ConvBnReLU(16, 16)
        self.conv5 = ConvBnReLU(16, 32, kernel=5, stride=2)
        self.conv6 = ConvBnReLU(32, 32)
        self.feature = nn.Conv2d(32, 32, 3, padding=1)

    def forward(self, x, train: bool = False):
        for i in range(7):
            x = getattr(self, f"conv{i}")(x, train)
        return self.feature(x)


class CostRegNet(nn.Module):
    """3D UNet: [1, 32, D, h, w] -> [1, 1, D, h, w]."""

    def __init__(self):
        super().__init__()
        self.conv0 = ConvBnReLU3D(32, 8)
        self.conv1 = ConvBnReLU3D(8, 16, stride=2)
        self.conv2 = ConvBnReLU3D(16, 16)
        self.conv3 = ConvBnReLU3D(16, 32, stride=2)
        self.conv4 = ConvBnReLU3D(32, 32)
        self.conv5 = ConvBnReLU3D(32, 64, stride=2)
        self.conv6 = ConvBnReLU3D(64, 64)
        self.conv7 = DeconvBnReLU3D(64, 32)
        self.conv9 = DeconvBnReLU3D(32, 16)
        self.conv11 = DeconvBnReLU3D(16, 8)
        self.prob = nn.Conv3d(8, 1, 3, padding=1)

    def forward(self, x, train: bool = False):
        c0 = self.conv0(x, train)
        c2 = self.conv2(self.conv1(c0, train), train)
        c4 = self.conv4(self.conv3(c2, train), train)
        x = self.conv6(self.conv5(c4, train), train)
        x = c4 + self.conv7(x, train)
        x = c2 + self.conv9(x, train)
        x = c0 + self.conv11(x, train)
        return self.prob(x)


def homo_warp(src_feat: torch.Tensor, proj: torch.Tensor,
              depth_values: torch.Tensor,
              align_corners: bool = True) -> torch.Tensor:
    """Plane-sweep warp of one source feature map into the reference view.
    src_feat [C, h, w]; proj [4, 4] (src @ inv(ref) at feature resolution);
    depth_values [D]. Returns [C, D, h, w]. align_corners=False reproduces
    the reference's as-run grid_sample (samples at px * w / (w - 1) - 0.5);
    samples behind the camera (z <= 1e-6) are zero."""
    C, H, W = src_feat.shape
    D = depth_values.shape[0]
    dev = src_feat.device
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    xyz = torch.stack([x, y, torch.ones_like(x)], 0).reshape(3, -1)
    rot = proj[:3, :3]
    trans = proj[:3, 3:4]
    rot_xyz = rot @ xyz                                        # [3, h*w]
    pts = rot_xyz[:, None, :] * depth_values[None, :, None] + trans[:, :, None]
    z = pts[2]
    px = pts[0] / z
    py = pts[1] / z
    if not align_corners:
        px = px * (W / (W - 1)) - 0.5
        py = py * (H / (H - 1)) - 0.5
    sampled = bilinear_sample(src_feat, px.reshape(-1), py.reshape(-1))
    valid = (z.reshape(-1) > 1e-6).to(sampled.dtype)
    return (sampled * valid).reshape(C, D, H, W)


def depth_regression(prob: torch.Tensor,
                     depth_values: torch.Tensor) -> torch.Tensor:
    """Soft-argmax over depth. prob [D, h, w]; depth_values [D] -> [h, w]."""
    return torch.sum(prob * depth_values[:, None, None], 0)


class MVSNet(nn.Module):
    """The depth network of one reference view and V images (no batch
    axis)."""

    def __init__(self, align_corners: bool = True):
        super().__init__()
        self.align_corners = align_corners
        self.feature = FeatureNet()
        self.cost_regularization = CostRegNet()

    def extract_features(self, imgs: torch.Tensor, train: bool = False):
        """imgs [V, 3, H, W] -> [V, 32, H/4, W/4], one view at a time (each
        view's BatchNorm sees only that view, as in JAX)."""
        with mvs_precision():
            return torch.cat([self.feature(imgs[v:v + 1], train)
                              for v in range(imgs.shape[0])])

    def forward(self, imgs: torch.Tensor, proj_mats: torch.Tensor,
                depth_values: torch.Tensor, train: bool = False,
                features: Optional[torch.Tensor] = None):
        """imgs [V, 3, H, W] (view 0 the reference); proj_mats [V, 4, 4];
        depth_values [D]. Returns (depth [h, w], photometric confidence
        [h, w], features [V, 32, h, w], prob_volume [D, h, w])."""
        H, W = imgs.shape[2:4]
        D = depth_values.shape[0]
        assert H % 32 == 0 and W % 32 == 0 and D % 8 == 0, (
            f"MVSNet needs H,W divisible by 32 and D by 8 (UNet strides); "
            f"got H={H} W={W} D={D}")
        if features is None:
            features = self.extract_features(imgs, train)
        V = features.shape[0]
        # the variance cost volume, one warped view at a time, in view order
        vol_sum = vol_sq = None
        for v in range(V):
            w = homo_warp(features[v], proj_mats[v], depth_values,
                          self.align_corners)
            vol_sum = w if vol_sum is None else vol_sum + w
            vol_sq = w * w if vol_sq is None else vol_sq + w * w
            del w
        volume_variance = vol_sq / V - torch.square(vol_sum / V)
        del vol_sum, vol_sq
        with mvs_precision():
            cost = self.cost_regularization(volume_variance[None],
                                            train)[0, 0]       # [D, h, w]
        prob_volume = torch.softmax(cost, 0)
        depth = depth_regression(prob_volume, depth_values)
        # photometric confidence: the prob mass of the 4 depth bins around
        # the regressed index (pad (1, 2) + a 4-wide sum)
        pv = F.pad(prob_volume, (0, 0, 0, 0, 1, 2))
        sum4 = pv[:-3] + pv[1:-2] + pv[2:-1] + pv[3:]
        didx = torch.clamp(depth_regression(
            prob_volume, torch.arange(D, dtype=torch.float32,
                                      device=prob_volume.device)),
            0, D - 1).to(torch.int64)
        conf = torch.gather(sum4, 0, didx[None])[0].detach()
        return depth, conf, features, prob_volume
