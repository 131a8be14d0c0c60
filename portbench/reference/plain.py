"""The plain reference of the cells' render and training step: plain PyTorch
in float32 with TF32 off, independent of the program under test.

It imports nothing of the program. From the cloud's positions and the
configuration's numbers it works out for itself everything the program
derives: the occupancy of the scaled voxels and its dilation, the K nearest
points of each shading point (over the kernel_size neighborhood of its
voxel, at most P points a voxel, lowest ids first, within radius_limit, ties
to the lowest candidate lane), the ray samples and their jitter, the decode,
the march, the losses, the gradients and the two-group Adam step.

Frozen copies (commit 9ce5b3a), because the integer decisions (which ray
samples are shading slots, which points are neighbors) have to be taken on
the same float arithmetic as the program takes them:

- `_fma`, `_linear_depths`, `_xla_scan`, `near_far_linear` and the slot
  rank of `pointnerf_tpu_torch/ops/query.py`;
- `grid_bounds` of `pointnerf_tpu_torch/config.py` and `voxel_coords`,
  `flat_vid` and `kernel_offsets_layered` of `ops/grid.py`;
- `positional_encoding` of `ops/pe.py`.

The decode follows the published Point-NeRF aggregator at the cells'
settings (linear inverse-distance weights over the perspective dists of
agg_dist_pers 20, per-point density interpolated, agg_intrp_order 2):
every matrix product in float32, or, as the control, with its two inputs
rounded to float8 e4m3 (`quant="fp8"`), the precision below the bf16 the
configurations state.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

F32 = np.float32


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- the query's float arithmetic (frozen) ----------------------------------

def _fma(a, b, c):
    """round(a*b + c) in float32 with one rounding."""
    return (a.double() * b.double() + c.double()).float()


def _linear_depths(D: int, near: float, far: float):
    t = np.arange(D + 1, dtype=F32) * (F32(1.0) / F32(D))
    t[-1] = F32(1.0)
    tvals = (np.float64(F32(near) * (F32(1.0) - t))
             + np.float64(F32(far)) * np.float64(t)).astype(F32)
    seg = tvals[1:] - tvals[:-1]
    end = np.concatenate([[F32(near)],
                          F32(near) + np.cumsum(seg, dtype=F32)]).astype(F32)
    return seg, (F32(0.5) * (end[:-1] + end[1:])).astype(F32)


def _xla_scan(x, base: int = 16):
    """Inclusive float32 cumsum along the last axis, in blocks of `base`
    combined with the exclusive carry (the program's order of sums)."""
    R, N = x.shape
    if N <= base:
        cols = [x[:, 0]]
        for j in range(1, N):
            cols.append(cols[-1] + x[:, j])
        return torch.stack(cols, -1)
    n = -(-N // base) * base
    xp = torch.cat([x, x.new_zeros((R, n - N))], -1).view(R, n // base, base)
    cols = [xp[..., 0]]
    for j in range(1, base):
        cols.append(cols[-1] + xp[..., j])
    blocks = torch.stack(cols, -1)
    carry = _xla_scan(blocks[..., -1], base)
    excl = torch.cat([x.new_zeros((R, 1)), carry[:, :-1]], -1)
    return (blocks + excl[..., None]).reshape(R, n)[:, :N]


def ray_depths(R: int, D: int, near: float, far: float, jitter: float,
               u: Optional[torch.Tensor], dev):
    """Sample depths [R, D] of near_far_linear: segment midpoints, each
    segment scaled by 1 + jitter * (u - 0.5) when `u` is given."""
    seg, mid = (torch.from_numpy(a).to(dev)
                for a in _linear_depths(D, near, far))
    if u is None or jitter <= 0:
        return mid[None, :].expand(R, D)
    one = torch.ones((), device=dev)
    seg = seg[None, :] * _fma(torch.tensor(F32(jitter), device=dev),
                              u - 0.5, one)
    nearf = torch.tensor(F32(near), device=dev)
    end = torch.cat([nearf.expand(R, 1), nearf + _xla_scan(seg)], -1)
    return 0.5 * (end[:, :-1] + end[:, 1:])


def positional_encoding(x, freqs: int, ori: bool = False):
    fb = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    base = (x[..., None] * fb).reshape(x.shape[:-1] + (x.shape[-1] * freqs,))
    if ori:
        return torch.cat([x, torch.sin(base), torch.cos(base)], -1)
    return torch.stack([torch.sin(base), torch.cos(base)], -1).reshape(
        base.shape[:-1] + (2 * base.shape[-1],))


# -- the grid, worked out from the points ------------------------------------

def _offsets(size) -> np.ndarray:
    axes = [np.arange(-(int(k) // 2), (int(k) + 1) // 2) for k in size]
    ox, oy, oz = np.meshgrid(*axes, indexing="ij")
    return np.stack([ox.ravel(), oy.ravel(), oz.ravel()], -1).astype(np.int64)


def layered_offsets(size) -> np.ndarray:
    """Neighbor-voxel offsets in the order of their candidate lanes: by
    shell layer max(|x|, |y|, |z|), stable."""
    offs = _offsets(size)
    return offs[np.argsort(np.abs(offs).max(-1), kind="stable")]


class Geometry:
    """The scaled-voxel grid of a cloud [N, 3] (float32, on a device) under
    the query settings `q` (a dict of the configuration's "query" entry)."""

    def __init__(self, xyz: torch.Tensor, q: Dict):
        dev = xyz.device
        self.q = q
        vs, sc, ks = q["vsize"], q["vscale"], q["kernel_size"]
        r = q["ranges"]
        svs = [v * s for v, s in zip(vs, sc)]
        lo = [r[i] - svs[i] * ks[i] / 2 for i in range(3)]
        hi = [r[3 + i] + svs[i] * ks[i] / 2 for i in range(3)]
        self.vdim = [int(-(-((hi[i] - lo[i]) / vs[i]) // sc[i]))
                     for i in range(3)]
        self.lo = torch.tensor(lo, dtype=torch.float32, device=dev)
        self.inv = torch.from_numpy(F32(1.0) / np.asarray(svs, F32)).to(dev)
        self.vdim_t = torch.tensor(self.vdim, dtype=torch.int64, device=dev)
        self.K, self.P = q["K"], q["P"]
        # the reach, squared in double and rounded once to float32
        self.r2 = torch.tensor(F32((q["radius_limit_scale"]
                                    * max(vs[0], vs[1])) ** 2), device=dev)
        self.xyz = xyz
        vid, inb = self.flat(self.coords(xyz))
        pid = torch.arange(xyz.shape[0], device=dev)
        vid, pid = vid[inb], pid[inb]
        vid, order = torch.sort(vid, stable=True)
        pid = pid[order]
        self.cells, start, counts = self._runs(vid)
        if self.cells.numel() > q["max_o"]:
            raise ValueError(f"{self.cells.numel()} occupied voxels exceed "
                             f"max_o {q['max_o']}")
        self.start, self.count = start, counts.clamp(max=self.P)
        self.pid = pid
        self.query_offs = torch.from_numpy(_offsets(q["query_size"])).to(dev)
        self.kernel_offs = torch.from_numpy(
            layered_offsets(q["kernel_size"])).to(dev)

    @staticmethod
    def _runs(sorted_vid):
        new = torch.ones_like(sorted_vid, dtype=torch.bool)
        new[1:] = sorted_vid[1:] != sorted_vid[:-1]
        starts = new.nonzero()[:, 0]
        counts = torch.diff(torch.cat([starts, starts.new_tensor(
            [sorted_vid.numel()])]))
        return sorted_vid[starts], starts, counts

    def coords(self, xyz):
        c = torch.floor((xyz - self.lo) * self.inv)
        return c.clamp(-1.0, float(1 << 30)).to(torch.int64)

    def flat(self, c):
        inb = torch.all((c >= 0) & (c < self.vdim_t), dim=-1)
        gy, gz = self.vdim[1], self.vdim[2]
        return c[..., 0] * (gy * gz) + c[..., 1] * gz + c[..., 2], inb

    def _find(self, c):
        """Index into `cells` of the voxel at coords c [..., 3], -1 where it
        holds no point (or lies outside the grid)."""
        vid, inb = self.flat(c)
        i = torch.searchsorted(self.cells, vid).clamp(
            max=self.cells.numel() - 1)
        return torch.where(inb & (self.cells[i] == vid), i, -1)

    def occupied_dilated(self, pts):
        """Whether each point's voxel lies within the query_size
        neighborhood of an occupied voxel."""
        c = self.coords(pts)
        vid, inb = self.flat(c)
        hit = torch.zeros(pts.shape[:-1], dtype=torch.bool, device=pts.device)
        for o in self.query_offs:
            hit |= self._find(c + o) >= 0
        return hit & inb

    def knn(self, centers, valid, block: int = 32768):
        """(pid [C, K] int64, -1 none) of the K nearest points of each
        valid center among its neighborhood's candidates in reach."""
        out = []
        P, K = self.P, self.K
        j = torch.arange(P, device=centers.device)
        for s in range(0, centers.shape[0], block):
            cen, ok = centers[s:s + block], valid[s:s + block]
            c = self.coords(cen)
            _vid, inb = self.flat(c)
            ids = []
            for o in self.kernel_offs:
                i = self._find(c + o)
                st = self.start[i.clamp(min=0)]
                n = torch.where(i >= 0, self.count[i.clamp(min=0)], 0)
                lane = torch.where(j[None] < n[:, None],
                                   self.pid[(st[:, None] + j[None]).clamp(
                                       max=self.pid.numel() - 1)], -1)
                ids.append(lane)
            cand = torch.cat(ids, -1)                       # [B, Q*P]
            pxyz = self.xyz[cand.clamp(min=0)]
            dx = pxyz[..., 0] - cen[:, None, 0]
            dy = pxyz[..., 1] - cen[:, None, 1]
            dz = pxyz[..., 2] - cen[:, None, 2]
            d2 = dx * dx + dy * dy + dz * dz
            good = (cand >= 0) & (d2 <= self.r2) & (ok & inb)[:, None]
            d2 = torch.where(good, d2, torch.full_like(d2, float("inf")))
            top, idx = torch.sort(d2, dim=1, stable=True)
            top, idx = top[:, :K], idx[:, :K]
            out.append(torch.where(torch.isfinite(top),
                                   cand.gather(1, idx), -1))
        return torch.cat(out) if out else centers.new_zeros((0, K),
                                                            dtype=torch.long)


# -- shading points ------------------------------------------------------------

def shading_points(geo: Geometry, campos, raydir, depths, SR: int):
    """The first SR ray samples that land in dilated-occupied voxels.
    Returns (loc_w [R, SR, 3], mask [R, SR])."""
    R, D = depths.shape
    raypos = _fma(raydir[:, None, :], depths[..., None], campos)
    hit = geo.occupied_dilated(raypos)
    rank = torch.cumsum(hit.to(torch.int64), 1) - 1
    dst = torch.where(hit & (rank < SR), rank, SR)
    idx = torch.full((R, SR + 1), D, dtype=torch.int64, device=raydir.device)
    idx.scatter_(1, dst, torch.arange(D, device=raydir.device).expand(R, D)
                 .contiguous())
    idx = idx[:, :SR]
    mask = idx < D
    t = torch.gather(depths, 1, idx.clamp(max=D - 1))
    loc = _fma(raydir[:, None, :], t[..., None], campos)
    return torch.where(mask[..., None], loc, 0.0), mask


# -- decode and march ----------------------------------------------------------

def _fp8(t):
    """t rounded to float8 e4m3 (saturating at its largest value), with a
    straight-through gradient."""
    q = t.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(torch.float32)
    return t + (q - t).detach()


def _dense(x, layer, quant):
    w = layer["w"]
    if quant == "fp8":
        x, w = _fp8(x), _fp8(w)
    return x @ w + layer["b"]


def _leaky(x):
    return torch.where(x >= 0, x, 0.01 * x)


def w2pers(xyz, rot, campos):
    c = (xyz - campos) @ rot
    z = c[..., 2]
    return torch.stack([c[..., 0] / z, c[..., 1] / z, z], -1)


class Payload(NamedTuple):
    """The points' trainable payloads (and their fixed positions)."""
    xyz: torch.Tensor
    features: torch.Tensor
    conf: torch.Tensor
    color: torch.Tensor
    dirs: torch.Tensor


def decode(mlp: Dict, pts: Payload, pidx, loc_w, mask, campos, rot, raydir,
           agg: Dict, quant: Optional[str] = None):
    """Density and color of each shading point [S] from its K neighbors
    pidx [S, K] (-1 none). Returns (features [S, 4], weight [S, K],
    conf coefficient [S, K], valid [S])."""
    nb = pidx >= 0
    valid = nb.any(-1)
    idx = pidx.clamp(min=0)
    xyz = pts.xyz[idx]
    pers = w2pers(xyz, rot, campos)
    loc = w2pers(loc_w, rot, campos)
    xd = xyz - loc_w[:, None, :]
    pd = torch.stack([pers[..., 0] * pers[..., 2] - (loc[:, 0] * loc[:, 2])[:, None],
                      pers[..., 1] * pers[..., 2] - (loc[:, 1] * loc[:, 2])[:, None],
                      pers[..., 2] - loc[:, None, 2]], -1)
    dists = torch.where(nb[..., None], torch.cat([xd, pd], -1), 0.0)
    weight = nb / torch.linalg.norm(dists[..., :3], dim=-1).clamp(min=1e-6)
    weight = weight / weight.sum(-1, keepdim=True).clamp(min=1e-8)
    conf = pts.conf[idx][..., 0]
    conf_c = conf - (conf - conf.clamp(0.0001, 1.0)).detach()
    w = (weight * conf_c)[..., None]
    vpe = positional_encoding(raydir, agg["num_viewdir_freqs"], ori=True)
    ov, vpe = vpe[:, :3], vpe[:, 3:]
    feat = torch.where(nb[..., None], pts.features[idx], 0.0)
    sdir = torch.where(nb[..., None], pts.dirs[idx], 0.0)
    extras = torch.cat([torch.where(nb[..., None], pts.color[idx], 0.0),
                        sdir - ov[:, None], (sdir * ov[:, None]).sum(
                            -1, keepdim=True)], -1)
    h = torch.cat([feat, positional_encoding(feat, agg["num_feat_freqs"]),
                   positional_encoding(dists, agg["dist_xyz_freq"])], -1)
    for layer in mlp["block1"]:
        h = _leaky(_dense(h, layer, quant))
    h = torch.cat([h, extras], -1)
    for layer in mlp["block3"]:
        h = _leaky(_dense(h, layer, quant))
    alpha_pp = torch.nn.functional.softplus(
        _dense(h, mlp["alpha"][0], quant) - 1.0)
    alpha = (torch.where(nb[..., None], alpha_pp, 0.0) * w).sum(1)
    fagg = (torch.where(nb[..., None], h, 0.0) * w).sum(1)
    x = torch.cat([fagg, vpe], -1)
    layers = mlp["color"]
    for layer in layers[:-1]:
        x = _leaky(_dense(x, layer, quant))
    color = torch.sigmoid(_dense(x, layers[-1], quant)) * (1 + 2 * 0.001) \
        - 0.001
    feats = torch.cat([alpha, color], -1) * valid[:, None]
    return feats, weight, conf_c, valid


def march(feats, loc_pers_z, valid, vsize_z: float, bg):
    """Alpha compositing of [R, SR, 4] features; ray_dist from the cummax
    of perspective depth (one voxel at the end, where it is not positive,
    and where it is over two voxels). Returns the ray colors [R, 3]."""
    zmax = torch.cummax(loc_pers_z, dim=-1).values
    dist = torch.cat([zmax[:, 1:] - zmax[:, :-1],
                      torch.full_like(zmax[:, :1], vsize_z)], -1)
    bad = (dist < 1e-8) | (dist > 2 * vsize_z)
    dist = torch.where(bad, torch.full_like(dist, vsize_z), dist) * valid
    sigma = feats[..., 0] * valid
    opacity = 1.0 - torch.exp(-sigma * dist)
    acc = torch.cumprod(1.0 - opacity + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(acc[:, :1]), acc[:, :-1]], -1)
    color = (feats[..., 1:] * (opacity * trans)[..., None]).sum(1)
    return color + bg[None, :] * acc[:, -1:]


class RenderOut(NamedTuple):
    color: torch.Tensor        # [R, 3]
    ray_mask: torch.Tensor     # [R]
    weight: torch.Tensor       # [S, K] of the valid slots
    conf_c: torch.Tensor       # [S, K]
    slot_valid: torch.Tensor   # [S]


def render(mlp, pts: Payload, geo: Geometry, cfg: Dict, campos, rot, raydir,
           u: Optional[torch.Tensor] = None, quant: Optional[str] = None
           ) -> RenderOut:
    """Colors of rays [R, 3] from one camera. `u` [R, D] is the training
    jitter's draw (None when serving)."""
    q, rd = cfg["query"], cfg["render"]
    R = raydir.shape[0]
    near, far = float(rd["near_plane"]), float(rd["far_plane"])
    depths = ray_depths(R, q["z_depth_dim"], near, far,
                        rd["train_jitter"] if u is not None else 0.0, u,
                        raydir.device)
    loc_w, mask = shading_points(geo, campos, raydir, depths, q["SR"])
    SR = q["SR"]
    flat = mask.reshape(-1)
    sel = flat.nonzero()[:, 0]
    pidx = geo.knn(loc_w.reshape(-1, 3)[sel], flat[sel])
    rays = sel // SR
    feats, weight, conf_c, valid = decode(
        mlp, pts, pidx, loc_w.reshape(-1, 3)[sel], None, campos, rot,
        raydir[rays], cfg["agg"], quant)
    dense = torch.zeros((R * SR, 4), device=raydir.device)
    dense = dense.index_copy(0, sel, feats).view(R, SR, 4)
    vmask = torch.zeros(R * SR, dtype=torch.bool, device=raydir.device)
    vmask[sel] = valid
    vmask = vmask.view(R, SR)
    z = w2pers(loc_w, rot, campos)[..., 2]
    z = torch.where(vmask, z, 0.0)
    bg = torch.tensor(rd["bg_color"], dtype=torch.float32,
                      device=raydir.device)
    color = march(dense, z, vmask, q["vsize"][2], bg)
    return RenderOut(color, vmask.any(-1), weight[valid], conf_c[valid],
                     valid)


# -- training ----------------------------------------------------------------

def losses(out: RenderOut, gt, cfg: Dict):
    """The configuration's loss: the color items (masked MSE on the rays
    the query hit, MSE on the missed rays times their count, plain MSE),
    each plus 1e-6, and the zero-one regulariser on the conf coefficient."""
    lc = cfg["loss"]
    total = torch.zeros((), device=gt.device)
    for name, wgt in zip(lc["color_loss_items"], lc["color_loss_weights"]):
        if name == "ray_masked_coarse_raycolor":
            m = out.ray_mask.float()[:, None]
            loss = (m * (out.color - gt) ** 2).sum() / (m.sum() * 3).clamp(
                min=1.0)
        elif name == "ray_miss_coarse_raycolor":
            m = (~out.ray_mask).float()[:, None]
            loss = (m * (out.color - gt) ** 2).sum() / (m.sum() * 3).clamp(
                min=1.0) * m.sum()
        elif name == "coarse_raycolor":
            loss = ((out.color - gt) ** 2).mean()
        else:
            raise ValueError(f"loss item {name!r} is not in the reference")
        total = total + loss * wgt + 1e-6
    for name, wgt in zip(lc["zero_one_loss_items"],
                         lc["zero_one_loss_weights"]):
        if name != "conf_coefficient":
            raise ValueError(f"loss item {name!r} is not in the reference")
        eps = lc["zero_epsilon"]
        v = out.conf_c.clamp(eps, 1.0 - eps)
        vf = (out.weight > 0).float()
        total = total + wgt * ((vf * (torch.log(v) + torch.log(1.0 - v)))
                               .sum() / vf.sum().clamp(min=1.0))
    return total


MLP_ORDER = ("block1", "block3", "alpha", "color")
POINT_LEAVES = ("xyz", "features", "conf", "color", "dirs")


def leaf_names(mlp: Dict) -> List[str]:
    return [f"mlp.{b}.{i}.{k}" for b in MLP_ORDER for i in range(len(mlp[b]))
            for k in ("w", "b")] + [f"points.{n}" for n in POINT_LEAVES]


def leaves(mlp: Dict, pts: Payload) -> List[torch.Tensor]:
    return [mlp[b][i][k] for b in MLP_ORDER for i in range(len(mlp[b]))
            for k in ("w", "b")] + [getattr(pts, n) for n in POINT_LEAVES]


def _rebuild(mlp: Dict, flat: List[torch.Tensor]):
    it = iter(flat)
    m = {b: [{k: next(it) for k in ("w", "b")} for _ in mlp[b]]
         for b in MLP_ORDER}
    return m, Payload(*[next(it) for _ in POINT_LEAVES])


def train_steps(mlp: Dict, pts: Payload, geo: Geometry, cfg: Dict,
                batches: List[Dict], draws: List[torch.Tensor],
                quant: Optional[str] = None):
    """Follow len(batches) training steps from (mlp, pts): render with the
    jitter draw, the loss, every gradient (frozen attributes none), the
    two-group Adam (optax arithmetic: b1 0.9, b2 0.999, eps 1e-8, the
    schedule read at the count before the step). Returns (losses [n],
    first step's gradients {leaf: tensor}, final leaves {leaf: tensor})."""
    tr, pcfg = cfg["train"], cfg["points"]
    if tr["alter_step"] != 0 or tr["lr_policy"] != "iter_exponential_decay":
        raise ValueError("the reference follows the configurations' "
                         "schedule: no alternation, exponential decay")
    names = leaf_names(mlp)
    frozen = {"points.xyz": not pcfg["xyz_grad"],
              "points.features": not pcfg["feat_grad"],
              "points.conf": not pcfg["conf_grad"],
              "points.color": not pcfg["color_grad"],
              "points.dirs": not pcfg["dir_grad"]}
    flat = [t.detach().clone() for t in leaves(mlp, pts)]
    mu = [torch.zeros_like(t) for t in flat]
    nu = [torch.zeros_like(t) for t in flat]
    out_losses, first = [], None
    for step, (b, u) in enumerate(zip(batches, draws)):
        var = [t.detach().requires_grad_(not frozen.get(n, False))
               for n, t in zip(names, flat)]
        m, p = _rebuild(mlp, var)
        with torch.enable_grad():
            out = render(m, p, geo, cfg, b["campos"], b["rot"], b["raydir"],
                         u=u, quant=quant)
            loss = losses(out, b["gt"], cfg)
            need = [v for v in var if v.requires_grad]
            gs = iter(torch.autograd.grad(loss, need, allow_unused=True))
        grads = []
        for v in var:
            g = next(gs) if v.requires_grad else None
            grads.append(torch.zeros_like(v) if g is None else g.detach())
        out_losses.append(float(loss.detach()))
        if first is None:
            first = dict(zip(names, grads))
        c = step + 1
        for i, (n, g) in enumerate(zip(names, grads)):
            base = tr["lr"] if n.startswith("mlp.") else tr["plr"]
            lr = base * F32(tr["lr_decay_exp"]) ** (step / tr["lr_decay_iters"])
            mu[i] = 0.1 * g + 0.9 * mu[i]
            nu[i] = 0.001 * (g * g) + 0.999 * nu[i]
            upd = -float(lr) * ((mu[i] / (1 - 0.9 ** c))
                                / (torch.sqrt(nu[i] / (1 - 0.999 ** c))
                                   + 1e-8))
            flat[i] = flat[i] + upd
    return out_losses, first, dict(zip(names, flat))
