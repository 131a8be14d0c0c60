"""Procedural multi-object scenes with analytic ground truth.

A harder stand-in for the reference's NeRF-Synthetic benchmark scenes
(data/nerf_synth360_ft_dataset.py) than data/synthetic.py's single smooth
sphere: several textured primitives, thin structures, mutual occlusion, and
view-dependent (Blinn-Phong) specular shading. The analytic renderer gives
exact GT pixels at any resolution, so time-to-PSNR curves measured against
it are meaningful. The port's own copy of `pointnerf_tpu/data/procedural.py`
(same seeds, same arrays).

A scene is a list of primitives; each primitive supports
  - vectorized ray intersection (t, normal, hit-mask),
  - surface sampling (area-weighted points + normals) for the init cloud,
  - a procedural albedo + Blinn-Phong specular spec.

Primitive types: sphere, axis-aligned box, axis-aligned capped cylinder
(thin rods). All intersections are closed-form — no meshes, no SDF marching.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..camera import get_dtu_raydir
from .synthetic import look_at

LIGHT = np.asarray([0.577, 0.577, -0.577], np.float32)   # key light dir
BG = np.asarray([1.0, 1.0, 1.0], np.float32)             # white, like n360


# --------------------------------------------------------------------------
# Textures (albedo as a function of the hit point / normal)
# --------------------------------------------------------------------------

def tex_checker(p: np.ndarray, scale: float, c0, c1) -> np.ndarray:
    q = np.floor(p * scale).astype(np.int64)
    odd = (q[..., 0] + q[..., 1] + q[..., 2]) % 2
    return np.where(odd[..., None] > 0, np.asarray(c1, np.float32),
                    np.asarray(c0, np.float32))


def tex_bands(p: np.ndarray, scale: float, c0, c1) -> np.ndarray:
    w = 0.5 + 0.5 * np.sin(scale * (p[..., 0] + 2 * p[..., 1] - p[..., 2]))
    return (np.asarray(c0, np.float32) * (1 - w[..., None])
            + np.asarray(c1, np.float32) * w[..., None])


def tex_solid(p: np.ndarray, scale: float, c0, c1) -> np.ndarray:
    return np.broadcast_to(np.asarray(c0, np.float32),
                           p.shape[:-1] + (3,)).copy()


TEXTURES = {"checker": tex_checker, "bands": tex_bands, "solid": tex_solid}


@dataclass
class Material:
    texture: str = "solid"
    scale: float = 8.0
    c0: Tuple[float, float, float] = (0.8, 0.2, 0.2)
    c1: Tuple[float, float, float] = (0.9, 0.9, 0.9)
    specular: float = 0.0       # Blinn-Phong strength (view-dependent)
    shininess: float = 32.0

    def albedo(self, p: np.ndarray) -> np.ndarray:
        return TEXTURES[self.texture](p, self.scale, self.c0, self.c1)


# --------------------------------------------------------------------------
# Primitives
# --------------------------------------------------------------------------

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
        n = (p - c) / (self.radius + 1e-12)
        return t, n, hit

    def sample(self, n_pts: int, rng) -> Tuple[np.ndarray, np.ndarray]:
        v = rng.normal(size=(n_pts, 3)).astype(np.float32)
        v /= np.linalg.norm(v, axis=-1, keepdims=True) + 1e-9
        return np.asarray(self.center, np.float32) + v * self.radius, v

    def area(self) -> float:
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
        t0 = (lo - o) * inv
        t1 = (hi - o) * inv
        tmin = np.max(np.minimum(t0, t1), axis=-1)
        tmax = np.min(np.maximum(t0, t1), axis=-1)
        hit = (tmax >= tmin) & (tmax > 1e-4)
        t = np.where(tmin > 1e-4, tmin, tmax)      # inside-box: exit face
        p = o + d * t[..., None]
        # normal = axis of the face the hit point is closest to
        ctr = (lo + hi) * 0.5
        half = (hi - lo) * 0.5 + 1e-12
        q = (p - ctr) / half
        ax = np.argmax(np.abs(q), axis=-1)
        n = np.zeros_like(p)
        np.put_along_axis(n, ax[..., None],
                          np.take_along_axis(np.sign(q), ax[..., None],
                                             axis=-1), axis=-1)
        return t, n, hit

    def sample(self, n_pts: int, rng):
        lo = np.asarray(self.lo, np.float32)
        hi = np.asarray(self.hi, np.float32)
        sz = hi - lo
        areas = np.array([sz[1] * sz[2], sz[1] * sz[2], sz[0] * sz[2],
                          sz[0] * sz[2], sz[0] * sz[1], sz[0] * sz[1]])
        face = rng.choice(6, size=n_pts, p=areas / areas.sum())
        u = rng.rand(n_pts, 3).astype(np.float32)
        p = lo + u * sz
        n = np.zeros((n_pts, 3), np.float32)
        for f in range(6):
            m = face == f
            ax, sgn = f // 2, 1.0 if f % 2 else -1.0
            p[m, ax] = hi[ax] if f % 2 else lo[ax]
            n[m, ax] = sgn
        return p, n

    def area(self) -> float:
        sz = np.asarray(self.hi) - np.asarray(self.lo)
        return float(2 * (sz[0] * sz[1] + sz[1] * sz[2] + sz[0] * sz[2]))


@dataclass
class CylinderY:
    """Capped cylinder along +y: thin rods and pillars."""
    cx: float
    cz: float
    radius: float
    y0: float
    y1: float
    mat: Material = field(default_factory=Material)

    def intersect(self, o, d):
        ox = o[..., 0] - self.cx
        oz = o[..., 2] - self.cz
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

        # caps
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

    def sample(self, n_pts: int, rng):
        h = self.y1 - self.y0
        a_side = 2 * math.pi * self.radius * h
        a_cap = math.pi * self.radius ** 2
        total = a_side + 2 * a_cap
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

    def area(self) -> float:
        return float(2 * math.pi * self.radius * (self.y1 - self.y0)
                     + 2 * math.pi * self.radius ** 2)


# --------------------------------------------------------------------------
# Scene definitions
# --------------------------------------------------------------------------

def scene_cluster() -> List:
    """Three textured spheres (one strongly specular), two boxes, and four
    thin rods threaded between them — occlusion + thin structures +
    view-dependent highlights, all inside a ~[-0.6, 0.6] cube."""
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


def scene_thicket() -> List:
    """A grid 'thicket' of 14 thin rods of varying height/radius around a
    matte ground box and three small embedded spheres — the thin-structure
    stress case (reference analog: ficus/ship rigging)."""
    rng = np.random.RandomState(7)
    prims: List = [
        Box((-0.55, -0.52, -0.55), (0.55, -0.45, 0.55),
            Material("checker", 7.0, (0.75, 0.75, 0.7), (0.35, 0.4, 0.35))),
        Sphere((-0.2, -0.32, 0.1), 0.12,
               Material("bands", 18.0, (0.8, 0.3, 0.2), (0.95, 0.9, 0.3))),
        Sphere((0.22, -0.3, -0.18), 0.14,
               Material("solid", 1.0, (0.2, 0.4, 0.75), (0, 0, 0),
                        specular=0.6, shininess=48.0)),
        Sphere((0.05, -0.36, 0.3), 0.09,
               Material("checker", 20.0, (0.3, 0.65, 0.3), (0.9, 0.9, 0.9))),
    ]
    hues = [(0.75, 0.45, 0.15), (0.5, 0.6, 0.2), (0.4, 0.3, 0.2),
            (0.65, 0.55, 0.35)]
    for i in range(14):
        cx = float(rng.uniform(-0.45, 0.45))
        cz = float(rng.uniform(-0.45, 0.45))
        r = float(rng.uniform(0.008, 0.022))
        h = float(rng.uniform(0.35, 0.95))
        prims.append(CylinderY(cx, cz, r, -0.45, -0.45 + h,
                               Material("solid", 1.0, hues[i % 4], (0, 0, 0))))
    return prims


SCENES = {"cluster": scene_cluster, "thicket": scene_thicket}


# --------------------------------------------------------------------------
# Analytic renderer + cloud sampling
# --------------------------------------------------------------------------

def gt_render(prims: List, campos: np.ndarray, raydir: np.ndarray,
              bg: np.ndarray = BG) -> np.ndarray:
    """Closest-hit shading over all primitives. raydir [R,3] (need not be
    normalized; t is in units of |raydir| like the sphere renderer)."""
    d = raydir / (np.linalg.norm(raydir, axis=-1, keepdims=True) + 1e-9)
    o = np.broadcast_to(campos[None, :], d.shape).astype(np.float32)
    best_t = np.full(d.shape[:-1], np.inf, np.float32)
    best_col = np.broadcast_to(bg, d.shape).copy().astype(np.float32)
    for prim in prims:
        t, n, hit = prim.intersect(o, d)
        closer = hit & (t < best_t)
        if not closer.any():
            continue
        p = o + d * t[..., None]
        albedo = prim.mat.albedo(p)
        lam = np.clip(np.sum(n * LIGHT[None], axis=-1), 0.0, 1.0) * 0.6 + 0.4
        col = albedo * lam[..., None]
        if prim.mat.specular > 0:
            h_vec = LIGHT[None] - d
            h_vec = h_vec / (np.linalg.norm(h_vec, axis=-1, keepdims=True)
                             + 1e-9)
            spec = np.clip(np.sum(n * h_vec, axis=-1), 0.0, 1.0) \
                ** prim.mat.shininess
            col = col + prim.mat.specular * spec[..., None]
        best_t = np.where(closer, t, best_t)
        best_col = np.where(closer[..., None], np.clip(col, 0.0, 1.0),
                            best_col)
    return best_col.astype(np.float32)


def sample_cloud(prims: List, n_pts: int, seed: int = 0):
    """Area-weighted surface sampling across all primitives. Returns
    (xyz [N,3], color [N,3] shaded albedo, normals [N,3]) — the same triple
    sphere_scene returns, usable as the init cloud."""
    rng = np.random.RandomState(seed)
    areas = np.array([p.area() for p in prims], np.float64)
    counts = np.maximum(1, (areas / areas.sum() * n_pts)).astype(int)
    # fix rounding to hit n_pts exactly
    while counts.sum() > n_pts:
        counts[np.argmax(counts)] -= 1
    while counts.sum() < n_pts:
        counts[np.argmax(areas)] += 1
    xs, cs, ns = [], [], []
    for prim, k in zip(prims, counts):
        p, n = prim.sample(int(k), rng)
        albedo = prim.mat.albedo(p)
        lam = np.clip(np.sum(n * LIGHT[None], axis=-1), 0.0, 1.0) * 0.6 + 0.4
        xs.append(p.astype(np.float32))
        cs.append((albedo * lam[..., None]).astype(np.float32))
        ns.append(n.astype(np.float32))
    return (np.concatenate(xs), np.clip(np.concatenate(cs), 0, 1),
            np.concatenate(ns))


def sphere_cameras(n_views: int, radius: float = 2.4, focal: float = 875.0,
                   wh: Tuple[int, int] = (800, 800), seed: int = 0,
                   hemisphere: bool = False):
    """n_views cameras on a full (or upper-hemisphere) sphere looking at the
    origin — the NeRF-Synthetic 100-view capture analog (focal 875 @800px
    ~ half the n360 fov ~ blender's 0.6911 rad). Deterministic Fibonacci
    spiral placement + small jitter."""
    W, H = wh
    K = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1]],
                 np.float32)
    rng = np.random.RandomState(seed)
    views = []
    ga = math.pi * (3.0 - math.sqrt(5.0))
    for i in range(n_views):
        z = 1.0 - 2.0 * (i + 0.5) / n_views
        if hemisphere:
            z = abs(z)
        r = math.sqrt(max(0.0, 1.0 - z * z))
        th = ga * i + rng.uniform(-0.03, 0.03)
        up = np.array([r * math.cos(th), z, r * math.sin(th)], np.float32)
        campos = up * radius
        # blender-style up = +y; degenerate at poles -> fall back to +x
        upv = (0.0, 1.0, 0.0) if abs(z) < 0.97 else (1.0, 0.0, 0.0)
        rot = look_at(campos, np.zeros(3, np.float32), up=upv)
        views.append((campos.astype(np.float32), rot, K))
    return views


def view_item(prims: List, campos, camrot, K, wh: Tuple[int, int],
              n_rays: Optional[int] = None, seed: int = 0,
              view_id: Optional[int] = None,
              pixels: Optional[np.ndarray] = None) -> Dict:
    """Sample pixels of one view with analytic GT (item-dict shape matches
    data/synthetic.view_ray_batch / the reference item keys).

    pixels: explicit [n, 2] (x, y) pixel selection (e.g. from
    train/sampler.ErrorMapSampler); overrides the uniform n_rays draw."""
    W, H = wh
    rng = np.random.RandomState(seed)
    if pixels is not None:
        pix = np.asarray(pixels, np.float32)
    elif n_rays is None:
        u, v = np.meshgrid(np.arange(W), np.arange(H))
        pix = np.stack([u.ravel(), v.ravel()], axis=-1).astype(np.float32)
    else:
        pix = np.stack([rng.randint(0, W, n_rays),
                        rng.randint(0, H, n_rays)],
                       axis=-1).astype(np.float32)
    raydir = get_dtu_raydir(pix, K, camrot, True).astype(np.float32)
    gt = gt_render(prims, campos, raydir)
    return {"campos": campos, "camrotc2w": camrot, "raydir": raydir,
            "pixel_idx": pix.astype(np.int32), "gt_image": gt,
            "intrinsic": K, "id": view_id}
