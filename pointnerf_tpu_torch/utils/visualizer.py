"""Training observability: loss accumulation, log file, image and point
dumps, optional tensorboardX.

Counterpart of `pointnerf_tpu/utils/visualizer.py` (`to8b`, `Visualizer`
without `gen_video`). Losses may be device tensors: they are held as they
are and read back once per print. PNG files are written (`write_png`) and
read (`read_png`) with the standard library (zlib + struct), so no image
package is needed.
"""
from __future__ import annotations

import os
import struct
import time
import zlib
from typing import Dict, Optional

import numpy as np
import torch


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """An [H, W] or [H, W, 1|2|3|4] uint8 array (grey, grey+alpha, RGB,
    RGBA) as a PNG file (filter type 0 on every row, one zlib stream)."""
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img, np.uint8).reshape(h, -1)],
                          axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # color type -> channels


def _unfilter(raw: np.ndarray, H: int, W: int, c: int) -> np.ndarray:
    """Undo the PNG row filters (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)
    of [H, 1 + W*c] scanlines. Each byte depends on its left, upper and
    upper-left neighbors, so pixels are reconstructed one anti-diagonal at
    a time (H + W - 1 vectorized steps), each pixel by its row's filter."""
    ftype = raw[:, 0].astype(np.int32)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown filter type {ftype.max()}")
    filt = raw[:, 1:].reshape(H, W, c).astype(np.int32)
    if not ftype.any():
        return filt.astype(np.uint8)
    out = np.zeros((H + 1, W + 1, c), np.int32)   # zero row above, column left
    for d in range(H + W - 1):
        r = np.arange(max(0, d - W + 1), min(H, d + 1))
        col = d - r
        a, b, ul = out[r + 1, col], out[r, col + 1], out[r, col]
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
        ft = ftype[r][:, None]
        pred = np.where(ft == 1, a, np.where(ft == 2, b, np.where(
            ft == 3, (a + b) >> 1, np.where(ft == 4, paeth, 0))))
        out[r + 1, col + 1] = (filt[r, col] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced grey, grey+alpha, RGB or RGBA PNG file as a
    uint8 array: [H, W] for grey, else [H, W, 2|3|4] (the layout imageio
    returns). Anything else raises. Standard library only (zlib)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype, _comp, _filt, interlace = ihdr
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey, grey+"
                         f"alpha, RGB and RGBA are read (bit depth {depth}, "
                         f"color type {ctype}, interlace {interlace})")
    c = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * c):
        raise ValueError(f"{path}: {raw.size} bytes of scanlines for "
                         f"{W}x{H}x{c}")
    img = _unfilter(raw.reshape(H, 1 + W * c), H, W, c)
    return img[..., 0] if c == 1 else img


class Visualizer:
    def __init__(self, run_dir: str, name: str = "run",
                 use_tensorboard: bool = False):
        self.run_dir = run_dir
        self.name = name
        os.makedirs(run_dir, exist_ok=True)
        self.log_path = os.path.join(run_dir, "log.txt")
        self._acc: Dict[str, list] = {}
        self._t0 = time.time()
        self.tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
                self.tb = SummaryWriter(os.path.join(run_dir, "tb"))
            except ImportError:
                self.tb = None

    # ---- losses ----------------------------------------------------------
    def reset(self):
        self._acc.clear()

    def accumulate_losses(self, items: Dict[str, object]):
        """Accepts floats or tensors; tensors stay on their device until
        `print_losses` reads them."""
        for k, v in items.items():
            self._acc.setdefault(k, []).append(v)

    def print_losses(self, step: int) -> Dict[str, float]:
        """Print and log the mean of each accumulated loss since the last
        print (one device read for all tensor-valued losses)."""
        keys = list(self._acc)
        means: Dict[str, float] = {}
        dev = [k for k in keys if torch.is_tensor(self._acc[k][0])]
        if dev:
            vals = torch.stack([torch.stack(self._acc[k]).float().mean()
                                for k in dev]).cpu().tolist()
            means.update(zip(dev, vals))
        for k in keys:
            if k not in means:
                means[k] = float(np.mean(self._acc[k]))
        dt = time.time() - self._t0
        msg = f"[{self.name}] step {step} t={dt:.1f}s " + " ".join(
            f"{k}={v:.5f}" for k, v in sorted(means.items()))
        print(msg, flush=True)
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")
        if self.tb is not None:
            for k, v in means.items():
                self.tb.add_scalar(k, v, step)
        self.reset()
        return means

    # ---- images / points -------------------------------------------------
    def save_image(self, img: np.ndarray, name: str, subdir: str = "images"):
        d = os.path.join(self.run_dir, subdir)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, name)
        write_png(path, to8b(img))
        return path

    def save_neural_points(self, name: str, xyz: np.ndarray,
                           color: Optional[np.ndarray] = None,
                           subdir: str = "points"):
        """The reference's txt format: `x;y;z;r;g;b` rows with colors in
        0..255."""
        d = os.path.join(self.run_dir, subdir)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{name}.txt")
        if color is None:
            color = np.ones_like(xyz) * 128
        else:
            color = to8b(color).astype(np.float32)
        rows = np.concatenate([xyz, color[:, :3]], axis=-1)
        with open(path, "w") as f:
            for r in rows:
                f.write(";".join(f"{v:.6f}" for v in r) + "\n")
        return path

    def save_options(self, cfg_json: str):
        with open(os.path.join(self.run_dir, "opt.json"), "w") as f:
            f.write(cfg_json)
