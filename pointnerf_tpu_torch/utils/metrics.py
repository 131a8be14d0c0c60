"""Image quality metrics: PSNR / SSIM / RMSE (+ optional LPIPS + proxy).

A numpy copy of `pointnerf_tpu/utils/metrics.py` (the port imports nothing
of the JAX package): PSNR, SSIM with an 11x11 uniform window averaged over
channels (as skimage's structural_similarity(win_size=11)), RMSE, LPIPS when
the optional `lpips` package and its weights are installed (None otherwise,
never a stand-in number), and `lpips_proxy`, a fixed-seed random-conv
feature distance that is comparable across runs of this code only.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def psnr(img: np.ndarray, gt: np.ndarray, max_val: float = 1.0) -> float:
    mse = float(np.mean((img.astype(np.float64) - gt.astype(np.float64)) ** 2))
    if mse <= 1e-12:
        return 99.0
    return float(10.0 * np.log10(max_val * max_val / mse))


def rmse(img: np.ndarray, gt: np.ndarray) -> float:
    return float(np.sqrt(np.mean(
        (img.astype(np.float64) - gt.astype(np.float64)) ** 2)))


def _uniform_filter2d(x: np.ndarray, win: int) -> np.ndarray:
    """Mean filter with an integral image ('valid' region padded by edge
    replication is unnecessary — SSIM uses the valid crop like skimage)."""
    pad = np.cumsum(np.cumsum(x, axis=0), axis=1)
    pad = np.pad(pad, ((1, 0), (1, 0)), mode="constant")
    h, w = x.shape
    out = (pad[win:h + 1, win:w + 1] - pad[:h + 1 - win, win:w + 1]
           - pad[win:h + 1, :w + 1 - win] + pad[:h + 1 - win, :w + 1 - win])
    return out / (win * win)


def ssim(img: np.ndarray, gt: np.ndarray, win: int = 11,
         max_val: float = 1.0) -> float:
    """Mean SSIM over the valid window region, averaged over channels."""
    img = img.astype(np.float64)
    gt = gt.astype(np.float64)
    if img.ndim == 2:
        img, gt = img[..., None], gt[..., None]
    C1 = (0.01 * max_val) ** 2
    C2 = (0.03 * max_val) ** 2
    vals = []
    for c in range(img.shape[-1]):
        x, y = img[..., c], gt[..., c]
        mx = _uniform_filter2d(x, win)
        my = _uniform_filter2d(y, win)
        # skimage uses unbiased (N/(N-1)) covariance normalization
        n = win * win
        cov_norm = n / (n - 1.0)
        vx = cov_norm * (_uniform_filter2d(x * x, win) - mx * mx)
        vy = cov_norm * (_uniform_filter2d(y * y, win) - my * my)
        vxy = cov_norm * (_uniform_filter2d(x * y, win) - mx * my)
        s = (((2 * mx * my + C1) * (2 * vxy + C2))
             / ((mx * mx + my * my + C1) * (vx + vy + C2)))
        vals.append(np.mean(s))
    return float(np.mean(vals))


# ---------------------------------------------------------------------------
# Perceptual-distance proxy (the real LPIPS needs pretrained weights that
# may not be installed, run/evaluate.py:42): distance in the feature space of a FIXED-SEED random
# conv pyramid. Random convolutional features are a documented stand-in for
# trained perceptual features (random VGG features track perceptual
# similarity; the channel-unit-normalize + spatial-average form follows the
# LPIPS recipe). Reported as `lpips_proxy`, never as LPIPS — the numbers are
# comparable across runs of THIS framework, not to published LPIPS values.
# ---------------------------------------------------------------------------

_PROXY_FILTERS: Optional[list] = None


def _proxy_filters(seed: int = 1234) -> list:
    """3-stage random conv bank (3->16->32->64 channels, 3x3, stride-2 pool),
    orthogonalized per-stage for a well-conditioned feature map."""
    global _PROXY_FILTERS
    if _PROXY_FILTERS is None:
        rng = np.random.RandomState(seed)
        chans = [(3, 16), (16, 32), (32, 64)]
        banks = []
        for cin, cout in chans:
            w = rng.randn(cout, cin * 9)
            # orthonormal rows -> roughly norm-preserving stage
            u, _s, vt = np.linalg.svd(w, full_matrices=False)
            banks.append((u @ vt).reshape(cout, cin, 3, 3).astype(np.float32))
        _PROXY_FILTERS = banks
    return _PROXY_FILTERS


def _conv2d(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """x: [H, W, Cin]; w: [Cout, Cin, 3, 3] -> [H-2, W-2, Cout] (valid)."""
    H, W, Ci = x.shape
    co = w.shape[0]
    # im2col: [H-2, W-2, Ci*9]
    cols = np.empty((H - 2, W - 2, Ci * 9), np.float32)
    k = 0
    for dy in range(3):
        for dx in range(3):
            cols[..., k * Ci:(k + 1) * Ci] = x[dy:H - 2 + dy, dx:W - 2 + dx]
            k += 1
    wm = w.transpose(0, 2, 3, 1).reshape(co, -1)  # [Cout, 9*Ci] (dy,dx,Ci)
    return cols @ wm.T


def lpips_proxy(img: np.ndarray, gt: np.ndarray) -> float:
    """Perceptual-distance proxy in [0, ~2]: mean cosine-style distance of
    channel-normalized random conv features over 3 scales."""
    def feats(x):
        x = x.astype(np.float32) * 2.0 - 1.0
        out = []
        for w in _proxy_filters():
            x = _conv2d(x, w)
            x = np.maximum(x, 0.0)                       # ReLU
            out.append(x)
            h, w2 = x.shape[:2]
            x = x[:h - h % 2, :w2 - w2 % 2]
            x = 0.25 * (x[::2, ::2] + x[1::2, ::2]
                        + x[::2, 1::2] + x[1::2, 1::2])  # 2x2 mean pool
        return out

    d = 0.0
    for fa, fb in zip(feats(img), feats(gt)):
        na = fa / (np.linalg.norm(fa, axis=-1, keepdims=True) + 1e-10)
        nb = fb / (np.linalg.norm(fb, axis=-1, keepdims=True) + 1e-10)
        d += float(np.mean(np.sum((na - nb) ** 2, axis=-1)))
    return d / 3.0


_LPIPS_CACHE: Dict[str, object] = {}


def lpips_fn(net: str = "alex"):
    """Returns a callable(img, gt)->float or None if lpips is unavailable."""
    if net in _LPIPS_CACHE:
        return _LPIPS_CACHE[net]
    try:
        import lpips  # type: ignore
        import torch
        model = lpips.LPIPS(net=net)

        def run(img, gt):
            a = torch.from_numpy(np.transpose(img, (2, 0, 1))[None]).float() * 2 - 1
            b = torch.from_numpy(np.transpose(gt, (2, 0, 1))[None]).float() * 2 - 1
            with torch.no_grad():
                return float(model(a, b).item())
        _LPIPS_CACHE[net] = run
    except Exception:
        _LPIPS_CACHE[net] = None
    return _LPIPS_CACHE[net]


def report_metrics(imgs, gts,
                   metrics=("psnr", "ssim", "rmse", "lpips", "lpips_proxy"),
                   ) -> Dict[str, Optional[float]]:
    """Average metrics over an image list (reference run/evaluate.py:34-97)."""
    out: Dict[str, Optional[float]] = {}
    accum: Dict[str, list] = {m: [] for m in metrics}
    lp = lpips_fn("alex") if "lpips" in metrics else None
    lpv = lpips_fn("vgg") if "vgglpips" in metrics else None
    for img, gt in zip(imgs, gts):
        if "psnr" in metrics:
            accum["psnr"].append(psnr(img, gt))
        if "ssim" in metrics:
            accum["ssim"].append(ssim(img, gt))
        if "rmse" in metrics:
            accum["rmse"].append(rmse(img, gt))
        if "lpips" in metrics and lp is not None:
            accum["lpips"].append(lp(img, gt))
        if "vgglpips" in metrics and lpv is not None:
            accum["vgglpips"].append(lpv(img, gt))
        if "lpips_proxy" in metrics:
            accum["lpips_proxy"].append(lpips_proxy(img, gt))
    for m in metrics:
        out[m] = float(np.mean(accum[m])) if accum.get(m) else None
    return out
