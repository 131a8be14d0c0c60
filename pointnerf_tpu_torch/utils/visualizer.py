"""Training observability: loss accumulation, log file, image and point
dumps, optional tensorboardX.

Counterpart of `pointnerf_tpu/utils/visualizer.py` (`to8b`, `Visualizer`
with `gen_video`). Losses may be device tensors: they are held as they
are and read back once per print. PNG files are written (`write_png`) and
read (`read_png`, 8- and 16-bit) with the standard library (zlib + struct),
so no image package is needed for them. JPEG frames are decoded by Pillow
(`read_jpeg`), as imageio.v2.imread decodes them; `read_image` takes
either by the file's extension. A video is a directory of numbered PNG
frames unless the caller asks for a container, which needs imageio.
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


def _paeth(a, b, c):
    """The PNG Paeth predictor of left `a`, upper `b` and upper-left `c`
    (int arrays): whichever is nearest a + b - c, ties to a, then b."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_png(path: str, img: np.ndarray, filters=(0,)) -> None:
    """An [H, W] or [H, W, 1|2|3|4] uint8 (8-bit) or uint16 (16-bit) array
    (grey, grey+alpha, RGB, RGBA) as a PNG file, one zlib stream. Row r is
    stored with filter type filters[r % len(filters)] (0 None, 1 Sub, 2 Up,
    3 Average, 4 Paeth; default 0 on every row)."""
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    depth = 16 if img.dtype == np.uint16 else 8
    data = (np.ascontiguousarray(img, ">u2").view(np.uint8) if depth == 16
            else np.ascontiguousarray(img, np.uint8)).reshape(h, -1)
    ft = np.asarray(filters, np.uint8)[np.arange(h) % len(filters)]
    if ft.any():
        nb = c * depth // 8        # bytes a pixel: the filters' stride
        x = data.astype(np.int16)
        up = np.concatenate([np.zeros_like(x[:1]), x[:-1]])
        left = np.pad(x, ((0, 0), (nb, 0)))[:, :-nb]
        ul = np.pad(up, ((0, 0), (nb, 0)))[:, :-nb]
        pred = np.stack([np.zeros_like(x), left, up, (left + up) >> 1,
                         _paeth(left, up, ul)])[ft, np.arange(h)]
        data = ((x - pred) & 255).astype(np.uint8)
    rows = np.concatenate([ft[:, None], data], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                           color_type, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # color type -> channels


def _unfilter(raw: np.ndarray, H: int, W: int, c: int) -> np.ndarray:
    """Undo the PNG row filters (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)
    of [H, 1 + W*c] scanlines, c bytes a pixel. None, Sub and Up rows are
    undone a row at a time (Sub as a running sum along the row, mod 256).
    Average and Paeth read the reconstructed left, upper and upper-left
    bytes, so an image with such rows is undone one anti-diagonal at a
    time: the rows are skewed so that anti-diagonal j is the slice T[j]
    (row r's pixel x at j = x + r + 2, row 0 of T the zeros above the
    image), H + W - 1 vectorized steps, each pixel by its row's filter."""
    ftype = raw[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown filter type {ftype.max()}")
    filt = raw[:, 1:].reshape(H, W, c)
    if ftype.max(initial=0) <= 2:
        out = np.empty_like(filt)
        prev = np.zeros_like(filt[0])
        for r in range(H):
            if ftype[r] == 1:
                prev = np.cumsum(filt[r], axis=0, dtype=np.uint8)
            else:
                prev = filt[r] + prev if ftype[r] == 2 else filt[r]
            out[r] = prev
        return out
    T = np.zeros((H + W + 1, H + 1, c), np.int16)
    F = np.zeros((H + W + 1, H, c), np.int16)
    for r in range(H):
        F[r + 2:r + 2 + W, r] = filt[r]
    ft = ftype[:, None]
    sub, up, avg, pae = ft == 1, ft == 2, ft == 3, ft == 4
    for j in range(2, H + W + 1):
        a, b, ul = T[j - 1, 1:], T[j - 1, :-1], T[j - 2, :-1]
        pred = np.where(sub, a, np.where(up, b, np.where(
            avg, (a + b) >> 1, np.where(pae, _paeth(a, b, ul), 0))))
        T[j, 1:] = (F[j] + pred) & 255
    return np.stack([T[r + 2:r + 2 + W, r + 1] for r in range(H)]
                    ).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """An 8- or 16-bit, non-interlaced grey, grey+alpha, RGB or RGBA PNG
    file as a uint8 (uint16) array: [H, W] for grey, else [H, W, 2|3|4]
    (the layout imageio returns). Anything else raises. Standard library
    only (zlib)."""
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
    if depth not in (8, 16) or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(f"{path}: only 8- and 16-bit non-interlaced grey, "
                         f"grey+alpha, RGB and RGBA are read (bit depth "
                         f"{depth}, color type {ctype}, interlace "
                         f"{interlace})")
    c = _PNG_CHANNELS[ctype]
    nb = c * depth // 8            # bytes a pixel: the filters' stride
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * nb):
        raise ValueError(f"{path}: {raw.size} bytes of scanlines for "
                         f"{W}x{H}x{c} at {depth} bits")
    img = _unfilter(raw.reshape(H, 1 + W * nb), H, W, nb)
    if depth == 16:                # big-endian samples
        img = img.reshape(H, W, c, 2).astype(np.uint16)
        img = (img[..., 0] << 8) | img[..., 1]
    return img[..., 0] if c == 1 else img


JPEG_EXT = (".jpg", ".jpeg")


def read_jpeg(path: str) -> np.ndarray:
    """A JPEG file as imageio.v2.imread returns it: Pillow's decode of its
    first frame as it is, uint8 [H, W] for grey and [H, W, 3] (4 for CMYK)
    for colour, the EXIF orientation tag not applied (imageio's pillow
    plugin leaves it unless asked). Raises ImportError, naming Pillow and
    the file, where Pillow does not import: there is no other decoder."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: JPEG frames are decoded by Pillow, "
                          f"which does not import here ({e})") from e
    with Image.open(path) as im:
        im.seek(0)
        return np.array(im)


def read_image(path: str) -> np.ndarray:
    """A frame by its extension: JPEG through `read_jpeg`, else `read_png`."""
    if path.lower().endswith(JPEG_EXT):
        return read_jpeg(path)
    return read_png(path)


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

    def gen_video(self, frames, name: str = "video", fps: int = 24,
                  container: Optional[str] = None) -> str:
        """Write `frames` ([H, W, 3] floats in [0, 1]) as numbered PNG files
        `<run_dir>/<name>/frame_00000.png`, ... and return that directory.
        With `container` ("mp4" or "gif") the frames are also encoded into
        `<run_dir>/<name>.<container>` by imageio, and that path is
        returned; a host without imageio raises."""
        d = os.path.join(self.run_dir, name)
        os.makedirs(d, exist_ok=True)
        for i, f in enumerate(frames):
            write_png(os.path.join(d, f"frame_{i:05d}.png"), to8b(f))
        if container is None:
            return d
        try:
            import imageio.v2 as imageio
        except ImportError as e:
            raise RuntimeError(f"a {container} video needs imageio, which "
                               "this host lacks; the frames are in " + d) \
                from e
        path = os.path.join(self.run_dir, f"{name}.{container}")
        imageio.mimwrite(path, [to8b(f) for f in frames], fps=fps)
        return path

    def save_options(self, cfg_json: str):
        with open(os.path.join(self.run_dir, "opt.json"), "w") as f:
            f.write(cfg_json)
