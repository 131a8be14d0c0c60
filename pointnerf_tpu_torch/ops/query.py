"""Ray sampling, shading-point selection and the K-nearest-neighbor query.

Counterpart of `pointnerf_tpu/ops/query.py`: the five ray generators of
`RAY_GENERATORS`, `sample_pdf` and `refine_ray_generation` (the fine
pass's importance resampling), `select_shading_points`,
`generate_shading_points`,
`knn_query` with every branch of `_knn_chunk` (prebuilt tables or bucket
rows; K nearest, the shell-layered cut or the NN=0 random subset; the
table path's plain K nearest is kernel K1, `ops/knn_select.py`) and the
dense neighbor query `query_points`. Static shapes as in JAX: all R rays
are kept and `sample_mask` / `ray_mask` carry validity.

Integer outputs (which ray samples are shading slots, which points are
neighbors) must equal the JAX package's, so the float arithmetic that decides
them follows what the compiled JAX reference does on the CPU: linspace
multiplies by the reciprocal of the step count, and a*b+c is one rounding
(emulated here by computing in float64 and rounding once).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import QueryConfig
from .grid import (GridMeta, PointGrid, flat_vid, grid_meta,
                   kernel_offsets_layered, voxel_coords)
from .knn_select import DEAD as KNN_DEAD
from .knn_select import knn_select


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """round(a*b + c) in float32 with one rounding of the product-sum."""
    return (a.double() * b.double() + c.double()).float()


def _linear_depths(D: int, near: float, far: float):
    """(segment lengths [D], segment midpoints [D]) of the un-jittered
    near_far_linear generator, float32 as the JAX package computes them."""
    f32 = np.float32
    t = np.arange(D + 1, dtype=f32) * (f32(1.0) / f32(D))
    t[-1] = f32(1.0)
    tvals = (np.float64(f32(near) * (f32(1.0) - t))
             + np.float64(f32(far)) * np.float64(t)).astype(f32)
    seg = tvals[1:] - tvals[:-1]
    end = np.concatenate([[f32(near)],
                          f32(near) + np.cumsum(seg, dtype=f32)]).astype(f32)
    return seg, (f32(0.5) * (end[:-1] + end[1:])).astype(f32)


def _xla_scan(x: torch.Tensor, mul: bool, base: int = 16) -> torch.Tensor:
    """Inclusive float32 cumsum (or cumprod with `mul`) along the last axis
    of x [R, N], combined in the order the compiled JAX package combines it
    on the CPU: XLA rewrites a long scan into blocks of `base` (combined in
    order inside a block), a scan of the block totals (the same way,
    recursively) and one combine with the exclusive carry. The same
    operations on every device, so the card and the CPU agree bit for bit.
    Out of place, so autograd can run through it."""
    op = torch.mul if mul else torch.add
    R, N = x.shape
    if N <= base:
        cols = [x[:, 0]]
        for j in range(1, N):
            cols.append(op(cols[-1], x[:, j]))
        return torch.stack(cols, -1)
    n = -(-N // base) * base
    ident = 1.0 if mul else 0.0
    xp = torch.cat([x, x.new_full((R, n - N), ident)], -1).view(R, n // base,
                                                                 base)
    cols = [xp[..., 0]]
    for j in range(1, base):
        cols.append(op(cols[-1], xp[..., j]))
    blocks = torch.stack(cols, -1)                       # [R, n/base, base]
    carry = _xla_scan(blocks[..., -1], mul, base)
    excl = torch.cat([x.new_full((R, 1), ident), carry[:, :-1]], -1)
    return op(blocks, excl[..., None]).reshape(R, n)[:, :N]


def _xla_cumsum(x: torch.Tensor, base: int = 16) -> torch.Tensor:
    """jnp.cumsum along the last axis of x [R, N], as compiled on the CPU."""
    return _xla_scan(x, mul=False, base=base)


def _xla_cumprod(x: torch.Tensor, base: int = 16) -> torch.Tensor:
    """jnp.cumprod along the last axis of x [R, N], as compiled on the
    CPU."""
    return _xla_scan(x, mul=True, base=base)


def _xla_sum(x: torch.Tensor, window: int = 32) -> torch.Tensor:
    """jnp.sum(x, -1, keepdims=True) of x [R, N] float32, as compiled on the
    CPU: a row longer than `window` is zero-padded to a multiple of it
    (half the padding in front), each window summed in order, and the
    window sums reduced the same way."""
    R, N = x.shape
    if N <= window:
        acc = x[:, :1]
        for j in range(1, N):
            acc = acc + x[:, j:j + 1]
        return acc
    n = -(-N // window) * window
    lo = (n - N) // 2
    xp = torch.cat([x.new_zeros((R, lo)), x, x.new_zeros((R, n - N - lo))],
                   -1).view(R, n // window, window)
    acc = xp[..., 0]
    for j in range(1, window):
        acc = acc + xp[..., j]
    return _xla_sum(acc, window)


def linspace_f32(start: float, stop: float, n: int) -> np.ndarray:
    """jnp.linspace(start, stop, n, dtype=float32) as compiled: with
    t = i * float32(1 / (n - 1)), start * (1 - t) + i * float32(stop / (n -
    1)) in float32 (XLA folds stop into the reciprocal), the last entry
    exactly stop."""
    f32 = np.float32
    if n == 1:
        return np.array([start], f32)
    i = np.arange(n - 1, dtype=f32)
    r = f32(1.0) / f32(n - 1)
    out = f32(start) * (f32(1.0) - i * r) + i * (f32(stop) * r)
    return np.append(out, f32(stop)).astype(f32)


def _lin_t(n: int, dev) -> torch.Tensor:
    """jnp.linspace(0, 1, n) as compiled: i * float32(1 / (n - 1)), the last
    entry exactly 1."""
    t = torch.arange(n, dtype=torch.float32, device=dev)
    if n > 1:
        t = t * torch.tensor(np.float32(1.0) / np.float32(n - 1), device=dev)
        t[-1] = 1.0
    return t


def _c(x: float, dev) -> torch.Tensor:
    return torch.tensor(np.float32(x), device=dev)


def _disparity(t: torch.Tensor, near: float, far: float) -> torch.Tensor:
    """1 / (1/near * (1 - t) + 1/far * t) in float32, the reciprocals of the
    Python floats rounded once and the sum one multiply-add, as compiled."""
    dev = t.device
    inv = _fma(_c(1.0 / far, dev), t, _c(1.0 / near, dev) * (1.0 - t))
    return 1.0 / inv


def _draw(u, generator, shape, dev):
    return (torch.rand(shape, generator=generator, device=dev) if u is None
            else u.float())


def _jittered(jitter: float, u, generator) -> bool:
    return jitter > 0.0 and (u is not None or generator is not None)


def near_far_linear_ray_generation(campos, raydir, point_count: int, near,
                                   far, jitter: float = 0.0,
                                   generator: Optional[torch.Generator] = None,
                                   u: Optional[torch.Tensor] = None):
    """Uniform-in-depth midpoint samples. campos [3]; raydir [R, 3].
    Returns (raypos [R, D, 3], seglen [R, D], tvals [R, D]).

    With jitter > 0 and a uniform draw — `u` [R, D] in [0, 1) if given,
    else drawn from `generator` (on raydir's device) — every segment length
    is scaled by 1 + jitter * (u - 0.5) before the cumsum, as in JAX. Without
    a draw the samples are not jittered (JAX: no key)."""
    R, D = raydir.shape[0], point_count
    dev = raydir.device
    seg, mid = (torch.from_numpy(a).to(dev)
                for a in _linear_depths(D, float(near), float(far)))
    if _jittered(jitter, u, generator):
        u = _draw(u, generator, (R, D), dev)
        # XLA contracts 1 + jitter * (u - 0.5) into one fused multiply-add
        seg = seg[None, :] * _fma(_c(jitter, dev), u - 0.5,
                                  torch.ones((), device=dev))
        nearf = _c(near, dev)
        end = torch.cat([nearf.expand(R, 1), nearf + _xla_cumsum(seg)], -1)
        mid = 0.5 * (end[:, :-1] + end[:, 1:])
    else:
        seg, mid = seg[None, :].expand(R, D), mid[None, :].expand(R, D)
    raypos = _fma(raydir[:, None, :], mid[..., None], campos)
    seglen = seg * torch.linalg.norm(raydir, dim=-1, keepdim=True)
    return raypos, seglen, mid


def near_far_disparity_linear_ray_generation(
        campos, raydir, point_count: int, near, far, jitter: float = 0.0,
        generator: Optional[torch.Generator] = None,
        u: Optional[torch.Tensor] = None):
    """Uniform-in-disparity samples; with jitter every bin value moves
    uniformly between its neighbors' midpoints (`u` [R, D + 1])."""
    R, D = raydir.shape[0], point_count
    dev = raydir.device
    tvals = _disparity(_lin_t(D + 1, dev), float(near), float(far))
    tvals = tvals[None, :].expand(R, D + 1)
    if _jittered(jitter, u, generator):
        u = _draw(u, generator, (R, D + 1), dev)
        mids = 0.5 * (tvals[:, 1:] + tvals[:, :-1])
        upper = torch.cat([mids, tvals[:, -1:]], -1)
        lower = torch.cat([tvals[:, :1], mids], -1)
        tvals = _fma(upper - lower, u, lower)
    mid = 0.5 * (tvals[:, :-1] + tvals[:, 1:])
    seglen = (tvals[:, 1:] - tvals[:, :-1]) * torch.linalg.norm(
        raydir, dim=-1, keepdim=True)
    raypos = _fma(raydir[:, None, :], mid[..., None], campos)
    return raypos, seglen, mid


def near_middle_far_ray_generation(
        campos, raydir, point_count: int, near, far, jitter: float = 0.0,
        generator: Optional[torch.Generator] = None,
        u: Optional[torch.Tensor] = None, middle: float = 2.0,
        middle_split: float = 0.6):
    """Linear from near to middle, uniform in disparity from middle to far,
    truncated to D segments as the JAX package does (the deepest 1-2
    disparity segments drop, a zero-length segment stays at the junction).
    With jitter, `u` is [R, n0 + n1 - 1]. The bin values are computed on
    the host (they depend on no input)."""
    R, D = raydir.shape[0], point_count
    dev, cpu = raydir.device, torch.device("cpu")
    n0 = int(D * middle_split) + 1
    n1 = int(D * (1.0 - middle_split)) + 2
    t0 = _lin_t(n0, cpu)
    vals0 = _fma(_c(middle, cpu), t0, _c(near, cpu) * (1.0 - t0))
    vals1 = _disparity(_lin_t(n1, cpu), float(middle), float(far))
    tv = torch.cat([vals0, vals1])
    seg = tv[1:] - tv[:-1]
    if _jittered(jitter, u, generator):
        u = _draw(u, generator, (R, seg.shape[0]), dev)
        seg = seg.to(dev)[None, :] * _fma(_c(jitter, dev), u - 0.5,
                                          torch.ones((), device=dev))
        seg = seg[:, :D]
        nearf = _c(near, dev)
        end = torch.cat([nearf.expand(R, 1), nearf + _xla_cumsum(seg)], -1)
        mid = 0.5 * (end[:, :-1] + end[:, 1:])
    else:
        seg = seg[:D].numpy()
        end = np.concatenate([[np.float32(near)], np.float32(near) + np.cumsum(
            seg, dtype=np.float32)]).astype(np.float32)
        mid = torch.from_numpy(0.5 * (end[:-1] + end[1:])).to(dev)
        seg = torch.from_numpy(seg).to(dev)[None, :].expand(R, D)
        mid = mid[None, :].expand(R, D)
    raypos = _fma(raydir[:, None, :], mid[..., None], campos)
    return raypos, seg, mid


def _nerf_stratified(tvals: torch.Tensor, R: int, jitter: float, generator,
                     u) -> torch.Tensor:
    """NeRF's stratified bin jitter: each bin value uniform between its
    neighbors' midpoints (`u` [R, n])."""
    n = tvals.shape[0]
    if _jittered(jitter, u, generator):
        u = _draw(u, generator, (R, n), tvals.device)
        mids = 0.5 * (tvals[1:] + tvals[:-1])
        upper = torch.cat([mids, tvals[-1:]])
        lower = torch.cat([tvals[:1], mids])
        return _fma((upper - lower)[None], u, lower[None])
    return tvals[None, :].expand(R, n)


def _nerf_tail(campos, raydir, tvals):
    R = raydir.shape[0]
    seg = torch.cat([tvals[:, 1:] - tvals[:, :-1],
                     torch.full((R, 1), 1e10, device=raydir.device)], -1)
    seg = seg * torch.linalg.norm(raydir, dim=-1, keepdim=True)
    raypos = _fma(raydir[:, None, :], tvals[..., None], campos)
    return raypos, seg, tvals


def nerf_near_far_linear_ray_generation(
        campos, raydir, point_count: int, near, far, jitter: float = 0.0,
        generator: Optional[torch.Generator] = None,
        u: Optional[torch.Tensor] = None):
    """NeRF-style samples at the (stratified) bin values themselves, the
    last segment open (1e10)."""
    dev = raydir.device
    t = _lin_t(point_count, dev)
    n, f = _c(near, dev), _c(far, dev)
    # near * (1 - t) + far * t is one multiply-add in the compiled query;
    # which product XLA contracts there depends on whether the bins are
    # jittered (the other choice moves some bins by 1 ulp, and with them
    # the shading positions)
    base = (_fma(f, t, n * (1.0 - t)) if _jittered(jitter, u, generator)
            else _fma(n, 1.0 - t, f * t))
    tvals = _nerf_stratified(base, raydir.shape[0], jitter, generator, u)
    return _nerf_tail(campos, raydir, tvals)


def nerf_near_far_disparity_linear_ray_generation(
        campos, raydir, point_count: int, near, far, jitter: float = 0.0,
        generator: Optional[torch.Generator] = None,
        u: Optional[torch.Tensor] = None):
    """NeRF-style samples uniform in disparity."""
    base = _disparity(_lin_t(point_count, raydir.device), float(near),
                      float(far))
    tvals = _nerf_stratified(base, raydir.shape[0], jitter, generator, u)
    return _nerf_tail(campos, raydir, tvals)


RAY_GENERATORS = {
    "near_far_linear": near_far_linear_ray_generation,
    "near_far_disparity_linear": near_far_disparity_linear_ray_generation,
    "near_middle_far": near_middle_far_ray_generation,
    "nerf_near_far_linear": nerf_near_far_linear_ray_generation,
    "nerf_near_far_disparity_linear":
        nerf_near_far_disparity_linear_ray_generation,
}


def _inverse_cdf(bins, weights, u):
    """Inverse-CDF draw at u [R, n] from the blend weights [R, S] over the
    bin midpoints [R, S-1] (the dense comparison-count searchsorted of the
    JAX package). Returns (samples [R, n], bin index [R, n] of the draw)."""
    w = weights[:, 1:-1] + 1e-5                              # [R, S-2]
    pdf = w / _xla_sum(w)
    cdf = _xla_cumsum(pdf)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)  # [R, S-1]
    inds = (cdf[:, None, :] <= u[:, :, None]).sum(-1)        # [R, n]
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=cdf.shape[-1] - 1)
    cdf_b, cdf_a = cdf.gather(1, below), cdf.gather(1, above)
    bin_b, bin_a = bins.gather(1, below), bins.gather(1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    frac = (u - cdf_b) / denom
    return _fma(frac, bin_a - bin_b, bin_b), inds


def sample_pdf(ts, weights, n_samples: int, det: bool = True,
               generator: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None):
    """Inverse-CDF importance sampling of new bin edges, merged and sorted
    with the old ones. ts [R, S] previous sample parameters; weights [R, S]
    blend weights. Returns [R, n_samples + S] sorted ts. With `det` (or no
    draw) u = linspace(0, 1, n_samples); else `u` [R, n_samples] if given,
    else drawn from `generator`."""
    R = ts.shape[0]
    bins = 0.5 * (ts[:, 1:] + ts[:, :-1])
    if det or (u is None and generator is None):
        u = _lin_t(n_samples, ts.device)[None, :].expand(R, n_samples)
    else:
        u = _draw(u, generator, (R, n_samples), ts.device)
    samples, _ = _inverse_cdf(bins, weights, u)
    merged = torch.cat([samples, ts.detach()], -1)
    return torch.sort(merged, dim=-1).values


def refine_ray_generation(campos, raydir, point_count: int, prev_ts,
                          prev_weights, jitter: float = 0.0,
                          generator: Optional[torch.Generator] = None,
                          u: Optional[torch.Tensor] = None):
    """Importance-refined ray samples from a previous pass's blend weights:
    `sample_pdf` draws point_count + 1 new bin edges (deterministic unless
    jitter > 0 and a draw `u` [R, point_count + 1] or `generator` is
    given), the samples sit at the midpoints. Returns (raypos [R, D', 3],
    seglen [R, D'], mid [R, D']) with D' = point_count + prev_ts.shape[1]."""
    det = not _jittered(jitter, u, generator)
    end = sample_pdf(prev_ts, prev_weights, point_count + 1, det=det,
                     generator=generator, u=u).detach()
    seg = end[:, 1:] - end[:, :-1]
    mid = 0.5 * (end[:, :-1] + end[:, 1:])
    raypos = campos + raydir[:, None, :] * mid[..., None]
    seg = seg * torch.linalg.norm(raydir, dim=-1, keepdim=True)
    return raypos, seg, mid


def select_shading_points(raypos: torch.Tensor, grid: PointGrid,
                          meta: GridMeta, SR: int, tvals: torch.Tensor,
                          campos: torch.Tensor, raydir: torch.Tensor):
    """The first SR ray samples (in depth order) that land in dilated-occupied
    voxels. One occupancy gather and a cumsum rank per ray; the JAX package's
    three formulations ("merge", "sort", "scatter") give the same result.
    Returns (sample_loc_w [R, SR, 3], sample_mask [R, SR])."""
    R, D, _ = raypos.shape
    G = meta.num_cells
    vid, inb = flat_vid(voxel_coords(raypos, meta), meta)       # [R, D]
    occ = grid.vox_occ[vid.clamp(max=G - 1).long()]
    hit = inb & (occ > 0)
    rank = torch.cumsum(hit.to(torch.int32), 1) - 1
    dst = torch.where(hit & (rank < SR), rank, SR).long()
    d_ar = torch.arange(D, dtype=torch.int64, device=raypos.device)
    idx = torch.full((R, SR + 1), D, dtype=torch.int64, device=raypos.device)
    idx.scatter_(1, dst, d_ar.expand(R, D).contiguous())
    idx = idx[:, :SR]                     # column SR collected the misses
    sample_mask = idx < D
    t = torch.gather(tvals, 1, idx.clamp(max=D - 1))               # [R, SR]
    sample_loc_w = _fma(raydir[:, None, :], t[..., None], campos)
    sample_loc_w = torch.where(sample_mask[..., None], sample_loc_w, 0.0)
    return sample_loc_w, sample_mask


_U32 = 0xFFFFFFFF


def _mix_u32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 finalizer on uint32 values held in int64 (torch has no full
    uint32 arithmetic): the products wrap in int64 and their low 32 bits,
    kept by the mask, are the uint32 products."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _U32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _U32
    return x ^ (x >> 16)


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 -> its uint32 value in int64 (-1 -> 0xFFFFFFFF)."""
    return t.long() & _U32


def _random_subset(pid, d2, cand_ok, centers, K: int):
    """NN=0: a uniform random K-subset of the in-radius candidates. Every
    candidate gets the JAX package's hash key of (center bits, point id),
    valid keys shifted below the invalid sentinel, and the K smallest keys
    win (stable sort: equal keys keep their candidate order)."""
    cb = _u32(centers.contiguous().view(torch.int32))            # [C, 3]
    hc = _mix_u32(cb[:, 0] ^ _mix_u32(cb[:, 1] ^ _mix_u32(cb[:, 2])))
    keys = _mix_u32(_u32(pid) ^ hc[:, None])
    keys = torch.where(cand_ok, keys >> 1, _U32)
    ks, order = torch.sort(keys, dim=1, stable=True)
    ok = ks[:, :K] < _U32
    win = order[:, :K]
    return (torch.where(ok, pid.gather(1, win), -1).to(torch.int32),
            torch.where(ok, d2.gather(1, win), float("inf")))


def _shell_cut(cand_ok, layer, K: int):
    """shell_layered: keep the candidates of the complete shells up to the
    first one where the running in-radius count reaches K (the last shell
    when none does). cand_ok [C, Q, P]; layer [Q] int64."""
    n_layers = int(layer.max()) + 1
    per = torch.stack([(cand_ok & (layer == l)[None, :, None]).sum((1, 2))
                       for l in range(n_layers)], -1)             # [C, L]
    reach = torch.cumsum(per, -1) >= K
    L = torch.where(reach.any(-1), reach.to(torch.int8).argmax(-1),
                    n_layers - 1)
    return cand_ok & (layer[None, :, None] <= L[:, None, None])


def _d2(dx, dy, dz):
    """Squared distance as (dx*dx + dy*dy) + dz*dz, each product rounded
    (no fused multiply-add, as K1 and its plain version sum it)."""
    return dx * dx + dy * dy + dz * dz


def _nearest(d2, cand_ok, K: int):
    """The K smallest candidate distances per row, ties to the lowest
    candidate index (what lax.top_k and K1 give). Returns (d2 [C, K],
    candidate index [C, K]); empty winners carry inf."""
    d2 = torch.where(cand_ok, d2, float("inf"))
    top_d2, top_i = torch.sort(d2, dim=1, stable=True)
    return top_d2[:, :K], top_i[:, :K]


def _knn_chunk(centers, center_valid, grid: PointGrid, meta: GridMeta,
               cfg: QueryConfig):
    """KNN for the centers [C, 3] of one chunk. Returns (pidx [C, K] int32
    -1-padded, d2 [C, K] inf-padded).

    With prebuilt tables each center reads its own cell's table row; else
    it reads the bucket rows of the Q kernel-offset cells around it. The
    selection is K1 on the table path with NN > 0 and no shell cut, as in
    the JAX package; the shell cut (`shell_layered`), the random subset
    (NN = 0) and the bucket path are torch code on every device, as they
    are XLA code in JAX."""
    C, K, P = centers.shape[0], cfg.K, cfg.P
    dev = centers.device
    G1 = grid.vox_slot.shape[0] - 1
    r2 = cfg.radius_limit ** 2
    offs, layer = kernel_offsets_layered(cfg.kernel_size)
    Q = offs.shape[0]
    ccoor = voxel_coords(centers, meta)
    if grid.nbr_xyz is not None:
        cvid, cinb = flat_vid(ccoor, meta)
        dslot = torch.where(cinb, grid.vox_dslot[cvid.clamp(max=G1).long()],
                            -1)
        ok = (dslot >= 0) & center_valid
        if cfg.NN > 0 and not cfg.shell_layered:
            return knn_select(grid.nbr_xyz, grid.nbr_pid,
                              dslot.to(torch.int32), centers.contiguous(),
                              ok.contiguous(), K=K, r2=r2)
        QP = Q * P
        dsc = dslot.clamp(min=0).long()
        row = grid.nbr_xyz[dsc].view(C, 3, QP)
        d2 = _d2(row[:, 0] - centers[:, 0:1], row[:, 1] - centers[:, 1:2],
                 row[:, 2] - centers[:, 2:3])
        cand_ok = ok[:, None] & (row[:, 0] < KNN_DEAD)
        pid = grid.nbr_pid[dsc]                                   # [C, QP]
    else:
        offs_t = torch.from_numpy(offs).to(dev)
        nvid, ninb = flat_vid(ccoor[:, None, :] + offs_t[None], meta)
        slot = torch.where(ninb, grid.vox_slot[nvid.clamp(max=G1).long()],
                           -1)                                    # [C, Q]
        has = slot >= 0
        slot_c = slot.clamp(min=0).long()
        pxyz = grid.bucket_xyz[slot_c]                            # [C,Q,P,3]
        cnt = torch.where(has, grid.bucket_cnt[slot_c], 0)
        cand_ok = (torch.arange(P, device=dev)[None, None, :]
                   < cnt[..., None]) & center_valid[:, None, None]
        diff = pxyz - centers[:, None, None, :]
        d2 = _d2(diff[..., 0], diff[..., 1], diff[..., 2]).reshape(C, Q * P)
        cand_ok = cand_ok.reshape(C, Q * P)
        pid = grid.bucket_pnt[slot_c].reshape(C, Q * P)
    if r2 > 0:
        cand_ok = cand_ok & (d2 <= r2)
    if cfg.NN <= 0:
        return _random_subset(pid, d2, cand_ok, centers, K)
    if cfg.shell_layered:
        lay = torch.from_numpy(layer).to(dev)
        cand_ok = _shell_cut(cand_ok.view(C, Q, P), lay, K).view(C, Q * P)
    top_d2, top_i = _nearest(d2, cand_ok, K)
    fin = torch.isfinite(top_d2)
    return (torch.where(fin, pid.gather(1, top_i), -1).to(torch.int32),
            torch.where(fin, top_d2, float("inf")))


def knn_query(sample_loc_w: torch.Tensor, sample_mask: torch.Tensor,
              xyz: torch.Tensor, grid: PointGrid, cfg: QueryConfig):
    """K nearest neural points for every shading point.
    sample_loc_w [..., 3]; sample_mask [...]. Returns (sample_pidx [..., K]
    int32, -1 invalid; d2 [..., K]). K1 takes the whole batch in one
    launch; the torch branches run `knn_chunk` centers at a time, as the
    JAX package does, to bound their [chunk, Q*P] workspace (chunking
    changes no result)."""
    meta = grid_meta(cfg)
    lead = sample_mask.shape
    centers = sample_loc_w.reshape(-1, 3)
    valid = sample_mask.reshape(-1)
    n = centers.shape[0]
    kernel = grid.nbr_xyz is not None and cfg.NN > 0 and not cfg.shell_layered
    step = n if kernel else max(1, min(cfg.knn_chunk, n))
    parts = [_knn_chunk(centers[s:s + step], valid[s:s + step], grid, meta,
                        cfg) for s in range(0, max(n, 1), step)]
    pidx = torch.cat([p for p, _ in parts])[:n]
    d2 = torch.cat([d for _, d in parts])[:n]
    return pidx.reshape(lead + (cfg.K,)), d2.reshape(lead + (cfg.K,))


def generate_shading_points(grid: PointGrid, campos, raydir, near: float,
                            far: float, cfg: QueryConfig,
                            jitter: float = 0.0,
                            generator: Optional[torch.Generator] = None,
                            gen_name: Optional[str] = None,
                            gen_kwargs: Tuple = (),
                            u: Optional[torch.Tensor] = None):
    """Ray generation + occupancy-selected shading locations (the pre-KNN
    half of the query). `gen_name` is a `RAY_GENERATORS` key (default by
    `cfg.inverse`), `gen_kwargs` its extra (name, value) pairs (e.g.
    near_middle_far's middle / middle_split); `generator` / `u` feed the
    jitter, `u` shaped as the generator draws it. Returns (sample_loc_w
    [R,SR,3], sample_mask [R,SR])."""
    name = gen_name or ("near_far_disparity_linear" if cfg.inverse > 0
                        else "near_far_linear")
    raypos, _seg, tvals = RAY_GENERATORS[name](
        campos, raydir, cfg.z_depth_dim, near, far, jitter=jitter,
        generator=generator, u=u, **dict(gen_kwargs))
    return select_shading_points(raypos, grid, grid_meta(cfg), cfg.SR,
                                 tvals.expand(raypos.shape[:2]), campos,
                                 raydir)


class QueryResult(NamedTuple):
    sample_pidx: torch.Tensor    # [R, SR, K] int32, -1 invalid
    sample_loc_w: torch.Tensor   # [R, SR, 3] world shading locations
    sample_mask: torch.Tensor    # [R, SR] bool: the slot has a neighbor
    ray_mask: torch.Tensor       # [R] bool: the ray has >= 1 neighbor


def query_points(xyz: torch.Tensor, grid: PointGrid, campos, raydir,
                 near: float, far: float, cfg: QueryConfig,
                 jitter: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 gen_name: Optional[str] = None, gen_kwargs: Tuple = (),
                 u: Optional[torch.Tensor] = None) -> QueryResult:
    """The dense neighbor query: shading points, their K nearest neural
    points on every [R, SR] slot, and the post-KNN masks (slots and rays
    whose query found no neighbor drop out)."""
    sample_loc_w, sample_mask = generate_shading_points(
        grid, campos, raydir, near, far, cfg, jitter=jitter,
        generator=generator, gen_name=gen_name, gen_kwargs=gen_kwargs, u=u)
    sample_pidx, _d2 = knn_query(sample_loc_w, sample_mask, xyz, grid, cfg)
    pnt_mask = sample_pidx >= 0
    ray_mask = pnt_mask.reshape(raydir.shape[0], -1).any(-1)
    return QueryResult(sample_pidx=sample_pidx, sample_loc_w=sample_loc_w,
                       sample_mask=sample_mask & pnt_mask.any(-1),
                       ray_mask=ray_mask)
