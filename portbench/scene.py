"""Scenes, cameras and the init cloud of the benchmark's cells, made from the
seed with no files.

Frozen copies, so that the yardstick does not move when the program does:

- the procedural cluster (its primitives, materials, analytic renderer and
  surface sampler) from `pointnerf_tpu_torch/data/procedural.py` and
  `look_at` from `data/synthetic.py`, commit 9ce5b3a, made self-contained;
- `get_dtu_raydir` from `pointnerf_tpu_torch/camera.py`, commit 9ce5b3a;
- the voxel downsample (`construct_vox_points_closest`) from
  `pointnerf_tpu_torch/ops/voxel.py`, commit 9ce5b3a.

Two kinds of scene (the configuration file's "scene" entry):

- "object": the cluster fitted into the preset's AABB by one uniform scale
  and shift, its surface sampled from the seed and downsampled at the
  preset's vox_res; cameras as NeRF-Synthetic's (training poses on the upper
  hemisphere, test poses on a ring), moved with the fit;
- "room": the cluster seen from a ring of depth cameras, back-projected from
  its analytic depth and downsampled at vox_res, as a ScanNet scan's sensor
  depth gives its cloud.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

LIGHT = np.asarray([0.577, 0.577, -0.577], np.float32)
BG = np.asarray([1.0, 1.0, 1.0], np.float32)


def _checker(p, scale, c0, c1):
    q = np.floor(p * scale).astype(np.int64)
    odd = (q[..., 0] + q[..., 1] + q[..., 2]) % 2
    return np.where(odd[..., None] > 0, np.asarray(c1, np.float32),
                    np.asarray(c0, np.float32))


def _bands(p, scale, c0, c1):
    w = 0.5 + 0.5 * np.sin(scale * (p[..., 0] + 2 * p[..., 1] - p[..., 2]))
    return (np.asarray(c0, np.float32) * (1 - w[..., None])
            + np.asarray(c1, np.float32) * w[..., None])


def _solid(p, scale, c0, c1):
    return np.broadcast_to(np.asarray(c0, np.float32),
                           p.shape[:-1] + (3,)).copy()


TEXTURES = {"checker": _checker, "bands": _bands, "solid": _solid}


@dataclass
class Material:
    texture: str = "solid"
    scale: float = 8.0
    c0: Tuple[float, float, float] = (0.8, 0.2, 0.2)
    c1: Tuple[float, float, float] = (0.9, 0.9, 0.9)
    specular: float = 0.0
    shininess: float = 32.0

    def albedo(self, p):
        return TEXTURES[self.texture](p, self.scale, self.c0, self.c1)


@dataclass
class Sphere:
    center: Tuple[float, float, float]
    radius: float
    mat: Material = field(default_factory=Material)

    def intersect(self, o, d):
        c = np.asarray(self.center, np.float32)
        oc = o - c
        b = np.sum(oc * d, axis=-1)
        cc = np.sum(oc * oc, axis=-1) - self.radius ** 2
        disc = b * b - cc
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        hit &= t > 1e-4
        p = o + d * t[..., None]
        return t, (p - c) / (self.radius + 1e-12), hit

    def sample(self, n_pts, rng):
        v = rng.normal(size=(n_pts, 3)).astype(np.float32)
        v /= np.linalg.norm(v, axis=-1, keepdims=True) + 1e-9
        return np.asarray(self.center, np.float32) + v * self.radius, v

    def area(self):
        return 4.0 * math.pi * self.radius ** 2


@dataclass
class Box:
    lo: Tuple[float, float, float]
    hi: Tuple[float, float, float]
    mat: Material = field(default_factory=Material)

    def intersect(self, o, d):
        lo = np.asarray(self.lo, np.float32)
        hi = np.asarray(self.hi, np.float32)
        inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)
        t0, t1 = (lo - o) * inv, (hi - o) * inv
        tmin = np.max(np.minimum(t0, t1), axis=-1)
        tmax = np.min(np.maximum(t0, t1), axis=-1)
        hit = (tmax >= tmin) & (tmax > 1e-4)
        t = np.where(tmin > 1e-4, tmin, tmax)
        p = o + d * t[..., None]
        q = (p - (lo + hi) * 0.5) / ((hi - lo) * 0.5 + 1e-12)
        ax = np.argmax(np.abs(q), axis=-1)
        n = np.zeros_like(p)
        np.put_along_axis(n, ax[..., None], np.take_along_axis(
            np.sign(q), ax[..., None], axis=-1), axis=-1)
        return t, n, hit

    def sample(self, n_pts, rng):
        lo = np.asarray(self.lo, np.float32)
        hi = np.asarray(self.hi, np.float32)
        sz = hi - lo
        areas = np.array([sz[1] * sz[2], sz[1] * sz[2], sz[0] * sz[2],
                          sz[0] * sz[2], sz[0] * sz[1], sz[0] * sz[1]])
        face = rng.choice(6, size=n_pts, p=areas / areas.sum())
        p = lo + rng.rand(n_pts, 3).astype(np.float32) * sz
        n = np.zeros((n_pts, 3), np.float32)
        for f in range(6):
            m = face == f
            ax, sgn = f // 2, 1.0 if f % 2 else -1.0
            p[m, ax] = hi[ax] if f % 2 else lo[ax]
            n[m, ax] = sgn
        return p, n

    def area(self):
        sz = np.asarray(self.hi) - np.asarray(self.lo)
        return float(2 * (sz[0] * sz[1] + sz[1] * sz[2] + sz[0] * sz[2]))


@dataclass
class CylinderY:
    cx: float
    cz: float
    radius: float
    y0: float
    y1: float
    mat: Material = field(default_factory=Material)

    def intersect(self, o, d):
        ox, oz = o[..., 0] - self.cx, o[..., 2] - self.cz
        dx, dz = d[..., 0], d[..., 2]
        a = dx * dx + dz * dz
        b = ox * dx + oz * dz
        c = ox * ox + oz * oz - self.radius ** 2
        disc = b * b - a * c
        ok = (disc > 0) & (a > 1e-12)
        sq = np.sqrt(np.maximum(disc, 0.0))
        t_side = (-b - sq) / np.where(a > 1e-12, a, 1.0)
        y = o[..., 1] + d[..., 1] * t_side
        side_hit = ok & (t_side > 1e-4) & (y >= self.y0) & (y <= self.y1)
        p = o + d * t_side[..., None]
        n_side = np.stack([p[..., 0] - self.cx, np.zeros_like(t_side),
                           p[..., 2] - self.cz], axis=-1)
        n_side /= (np.linalg.norm(n_side, axis=-1, keepdims=True) + 1e-12)
        dy = np.where(np.abs(d[..., 1]) < 1e-12, 1e-12, d[..., 1])
        best_t, best_n, best_hit = t_side, n_side, side_hit
        for ycap, nv in ((self.y1, 1.0), (self.y0, -1.0)):
            t_cap = (ycap - o[..., 1]) / dy
            pc = o + d * t_cap[..., None]
            r2 = (pc[..., 0] - self.cx) ** 2 + (pc[..., 2] - self.cz) ** 2
            cap_hit = (t_cap > 1e-4) & (r2 <= self.radius ** 2)
            closer = cap_hit & (~best_hit | (t_cap < best_t))
            best_t = np.where(closer, t_cap, best_t)
            ncap = np.zeros_like(best_n)
            ncap[..., 1] = nv
            best_n = np.where(closer[..., None], ncap, best_n)
            best_hit = best_hit | cap_hit
        return best_t, best_n, best_hit

    def sample(self, n_pts, rng):
        h = self.y1 - self.y0
        a_side = 2 * math.pi * self.radius * h
        total = a_side + 2 * math.pi * self.radius ** 2
        u = rng.rand(n_pts)
        th = rng.rand(n_pts) * 2 * math.pi
        p = np.zeros((n_pts, 3), np.float32)
        n = np.zeros((n_pts, 3), np.float32)
        side = u < a_side / total
        p[side, 0] = self.cx + self.radius * np.cos(th[side])
        p[side, 2] = self.cz + self.radius * np.sin(th[side])
        p[side, 1] = self.y0 + rng.rand(side.sum()) * h
        n[side, 0] = np.cos(th[side])
        n[side, 2] = np.sin(th[side])
        cap = ~side
        r = self.radius * np.sqrt(rng.rand(cap.sum()))
        top = rng.rand(cap.sum()) < 0.5
        p[cap, 0] = self.cx + r * np.cos(th[cap])
        p[cap, 2] = self.cz + r * np.sin(th[cap])
        p[cap, 1] = np.where(top, self.y1, self.y0)
        n[cap, 1] = np.where(top, 1.0, -1.0)
        return p, n

    def area(self):
        return float(2 * math.pi * self.radius * (self.y1 - self.y0)
                     + 2 * math.pi * self.radius ** 2)


def cluster() -> List:
    """Three textured spheres (one specular), two boxes and four thin rods
    inside a ~[-0.6, 0.6] cube."""
    m_check = Material("checker", 10.0, (0.85, 0.2, 0.15), (0.95, 0.9, 0.85))
    m_bands = Material("bands", 14.0, (0.15, 0.35, 0.8), (0.9, 0.85, 0.2))
    m_spec = Material("solid", 1.0, (0.25, 0.6, 0.3), (0, 0, 0),
                      specular=0.8, shininess=64.0)
    m_box = Material("checker", 16.0, (0.6, 0.5, 0.2), (0.25, 0.2, 0.5))
    m_rod = Material("solid", 1.0, (0.8, 0.4, 0.1), (0, 0, 0))
    return [
        Sphere((-0.25, 0.05, -0.15), 0.22, m_check),
        Sphere((0.28, -0.12, 0.12), 0.18, m_bands),
        Sphere((0.05, 0.3, 0.22), 0.14, m_spec),
        Box((-0.55, -0.5, -0.1), (-0.15, -0.3, 0.4), m_box),
        Box((0.1, -0.5, -0.45), (0.5, -0.05, -0.2),
            Material("bands", 9.0, (0.5, 0.2, 0.6), (0.9, 0.9, 0.9))),
        CylinderY(-0.05, 0.05, 0.012, -0.5, 0.55, m_rod),
        CylinderY(0.25, 0.3, 0.015, -0.5, 0.35, m_rod),
        CylinderY(-0.35, 0.25, 0.010, -0.5, 0.45,
                  Material("solid", 1.0, (0.2, 0.7, 0.7), (0, 0, 0))),
        CylinderY(0.42, -0.05, 0.013, -0.5, 0.5,
                  Material("solid", 1.0, (0.85, 0.8, 0.2), (0, 0, 0))),
    ]


def closest_hit(prims: List, o, d):
    """(t, normal, hit, primitive index) of each ray's closest hit; o, d
    [R, 3] with d of unit length."""
    best_t = np.full(d.shape[:-1], np.inf, np.float32)
    best_n = np.zeros_like(d)
    best_i = np.full(d.shape[:-1], -1, np.int64)
    for i, prim in enumerate(prims):
        t, n, hit = prim.intersect(o, d)
        closer = hit & (t < best_t)
        best_t = np.where(closer, t, best_t)
        best_n = np.where(closer[..., None], n, best_n)
        best_i = np.where(closer, i, best_i)
    return best_t, best_n, best_i >= 0, best_i


def shade(prims: List, p, n, d, idx) -> np.ndarray:
    """Lambert + Blinn-Phong color of hits on primitive `idx`."""
    col = np.zeros_like(p)
    for i, prim in enumerate(prims):
        m = idx == i
        if not m.any():
            continue
        lam = np.clip(np.sum(n[m] * LIGHT[None], -1), 0.0, 1.0) * 0.6 + 0.4
        c = prim.mat.albedo(p[m]) * lam[..., None]
        if prim.mat.specular > 0:
            h = LIGHT[None] - d[m]
            h = h / (np.linalg.norm(h, axis=-1, keepdims=True) + 1e-9)
            c = c + prim.mat.specular * (np.clip(np.sum(n[m] * h, -1), 0.0,
                                                 1.0) ** prim.mat.shininess
                                         )[..., None]
        col[m] = np.clip(c, 0.0, 1.0)
    return col


def gt_render(prims: List, campos, raydir) -> np.ndarray:
    """Analytic ground truth [R, 3]: the closest hit shaded, white on a
    miss."""
    d = raydir / (np.linalg.norm(raydir, axis=-1, keepdims=True) + 1e-9)
    o = np.broadcast_to(campos[None, :], d.shape).astype(np.float32)
    t, n, hit, idx = closest_hit(prims, o, d)
    p = o + d * np.where(hit, t, 0.0)[..., None]
    out = np.broadcast_to(BG, d.shape).copy()
    out[hit] = shade(prims, p[hit], n[hit], d[hit], idx[hit])
    return out.astype(np.float32)


def sample_surface(prims: List, n_pts: int, rng):
    """Area-weighted surface samples: (xyz, shaded albedo, normals)."""
    areas = np.array([p.area() for p in prims], np.float64)
    counts = np.maximum(1, (areas / areas.sum() * n_pts)).astype(int)
    while counts.sum() > n_pts:
        counts[np.argmax(counts)] -= 1
    while counts.sum() < n_pts:
        counts[np.argmax(areas)] += 1
    xs, cs, ns = [], [], []
    for prim, k in zip(prims, counts):
        p, n = prim.sample(int(k), rng)
        lam = np.clip(np.sum(n * LIGHT[None], -1), 0.0, 1.0) * 0.6 + 0.4
        xs.append(p.astype(np.float32))
        cs.append((prim.mat.albedo(p) * lam[..., None]).astype(np.float32))
        ns.append(n.astype(np.float32))
    return (np.concatenate(xs), np.clip(np.concatenate(cs), 0, 1),
            np.concatenate(ns))


def look_at(campos, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """OpenCV camera-to-world rotation with +z looking at `target`."""
    z = target - campos
    z = z / (np.linalg.norm(z) + 1e-9)
    x = np.cross(np.asarray(up, np.float32), z)
    x = x / (np.linalg.norm(x) + 1e-9)
    return np.stack([x, np.cross(z, x), z], axis=-1).astype(np.float32)


def intrinsic(focal: float, wh) -> np.ndarray:
    W, H = wh
    return np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1]],
                    np.float32)


def get_dtu_raydir(pix, K, camrot, dir_norm: bool):
    """Pixel coords [..., 2] -> world ray directions [..., 3] (numpy)."""
    x = (pix[..., 0] + 0.5 - K[0, 2]) / K[0, 0]
    y = (pix[..., 1] + 0.5 - K[1, 2]) / K[1, 1]
    dirs = np.stack([x, y, np.ones_like(x)], -1) @ camrot.T
    if dir_norm:
        dirs = dirs / (np.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-5)
    return dirs


def voxel_downsample(xyz: torch.Tensor, vox_res: int) -> torch.Tensor:
    """One point per occupied voxel of the cloud's AABB at vox_res^3 (cell =
    span / vox_res per axis), the one nearest the voxel's centroid (the first
    on a tie). Returns the kept indices in ascending voxel order."""
    mn, mx = xyz.amin(0), xyz.amax(0)
    cell = torch.clamp(mx - mn, min=1e-9) / vox_res
    c = torch.floor((xyz - mn) / cell).to(torch.int32).clamp(0, vox_res - 1)
    c = c.long()
    vid = (c[:, 0] * vox_res + c[:, 1]) * vox_res + c[:, 2]
    sv, order = torch.sort(vid, stable=True)
    new = torch.ones_like(sv, dtype=torch.bool)
    new[1:] = sv[1:] != sv[:-1]
    seg = torch.cumsum(new.long(), 0) - 1
    m = int(seg[-1]) + 1
    pts = xyz[order]
    sums = torch.zeros((m, 3), dtype=torch.float64,
                       device=xyz.device).index_add_(0, seg, pts.double())
    counts = torch.zeros(m, dtype=torch.float64, device=xyz.device
                         ).index_add_(0, seg, torch.ones_like(
                             seg, dtype=torch.float64))
    d = pts - (sums / counts[:, None]).float()[seg]
    d = d * d
    d2 = d[:, 0] + d[:, 1] + d[:, 2]
    by_d2 = torch.sort(d2, stable=True).indices
    rank = by_d2[torch.sort(seg[by_d2], stable=True).indices]
    first = torch.ones_like(new)
    first[1:] = seg[rank][1:] != seg[rank][:-1]
    return order[rank[first]]


class Camera:
    """One pinhole view: position [3], c2w rotation [3, 3], intrinsics."""

    def __init__(self, campos, rot, K):
        self.campos = np.asarray(campos, np.float32)
        self.rot = np.asarray(rot, np.float32)
        self.K = np.asarray(K, np.float32)


class Scene:
    """The cloud (numpy xyz, color, normals) and the cameras of one cell."""

    def __init__(self, prims, scale, shift, xyz, color, normals, train_cams,
                 test_cams, wh):
        self.prims, self.scale, self.shift = prims, scale, shift
        self.xyz, self.color, self.normals = xyz, color, normals
        self.train_cams, self.test_cams, self.wh = train_cams, test_cams, wh

    def gt(self, cam: Camera, raydir) -> np.ndarray:
        """Ground truth of rays from `cam` (world frame of the fit)."""
        o = (cam.campos - self.shift) / self.scale
        return gt_render(self.prims, o, raydir)


def _fit(ranges, margin: float):
    """Uniform scale and shift that put the cluster's box (~[-0.6, 0.6])
    inside the AABB `ranges`, centered."""
    lo, hi = np.asarray(ranges[:3]), np.asarray(ranges[3:])
    scale = float(margin * np.min(hi - lo) / 1.2)
    return scale, ((lo + hi) / 2.0).astype(np.float32)


def _ring(n, radius, height, phase, fit):
    scale, shift = fit
    cams = []
    for i in range(n):
        th = 2.0 * np.pi * (i + phase) / n
        p = np.array([radius * np.cos(th), height, radius * np.sin(th)],
                     np.float32)
        cams.append((p * scale + shift, look_at(p, np.zeros(3, np.float32))))
    return cams


def _hemisphere(n, radius, rng, fit):
    """Fibonacci placement on the upper hemisphere, with a small jitter."""
    scale, shift = fit
    ga = math.pi * (3.0 - math.sqrt(5.0))
    cams = []
    for i in range(n):
        z = abs(1.0 - 2.0 * (i + 0.5) / n)
        r = math.sqrt(max(0.0, 1.0 - z * z))
        th = ga * i + rng.uniform(-0.03, 0.03)
        p = np.array([r * math.cos(th), z, r * math.sin(th)],
                     np.float32) * radius
        up = (0.0, 1.0, 0.0) if z < 0.97 else (1.0, 0.0, 0.0)
        cams.append((p * scale + shift,
                     look_at(p, np.zeros(3, np.float32), up=up)))
    return cams


def build_scene(spec: Dict, ranges, vox_res: int, seed: int,
                device) -> Scene:
    """The scene of a configuration's "scene" entry, from the seed."""
    rng = np.random.RandomState(seed % (2 ** 32))
    prims = cluster()
    wh = tuple(spec["img_wh"])
    K = intrinsic(spec["focal"], wh)
    if spec["kind"] == "object":
        fit = _fit(ranges, spec["fit_margin"])
        xyz, col, nrm = sample_surface(prims, spec["surface_samples"], rng)
        radius = spec["distance"] / fit[0]      # in the cluster's units
        elev = math.radians(spec["test_elevation_deg"])
        train = _hemisphere(spec["train_views"], radius, rng, fit)
        test = _ring(spec["test_views"], radius * math.cos(elev),
                     radius * math.sin(elev), 0.0, fit)
    elif spec["kind"] == "room":
        fit = (1.0, np.zeros(3, np.float32))
        dw, dh = spec["depth_wh"]
        Kd = K.copy()
        Kd[0] *= dw / wh[0]
        Kd[1] *= dh / wh[1]
        gx, gy = np.meshgrid(np.arange(dw), np.arange(dh))
        pix = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
        xs, cs, ns = [], [], []
        for p, rot in _ring(spec["depth_views"], spec["radius"],
                            spec["height"], rng.uniform(0.0, 1.0), fit):
            d = get_dtu_raydir(pix, Kd, rot, True).astype(np.float32)
            o = np.broadcast_to(p, d.shape).astype(np.float32)
            t, n, hit, idx = closest_hit(prims, o, d)
            q = o[hit] + d[hit] * t[hit, None]
            xs.append(q.astype(np.float32))
            cs.append(shade(prims, q, n[hit], d[hit], idx[hit]))
            ns.append(n[hit].astype(np.float32))
        xyz, col, nrm = (np.concatenate(a) for a in (xs, cs, ns))
        train = _ring(spec["train_views"], spec["radius"], spec["height"],
                      rng.uniform(0.0, 1.0), fit)
        test = _ring(spec["test_views"], spec["radius"], spec["height"], 0.5,
                     fit)
    else:
        raise ValueError(f"unknown scene kind {spec['kind']!r}")
    scale, shift = fit
    xyz = xyz * scale + shift
    keep = voxel_downsample(torch.from_numpy(xyz).to(device), vox_res)
    keep = keep.cpu().numpy()
    return Scene(prims, scale, shift, xyz[keep].astype(np.float32),
                 col[keep].astype(np.float32), nrm[keep].astype(np.float32),
                 [Camera(p, r, K) for p, r in train],
                 [Camera(p, r, K) for p, r in test], wh)
