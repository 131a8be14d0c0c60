"""K1: fused KNN distance + K-nearest selection over the prebuilt neighbor
table rows.

Replaces `pointnerf_tpu/ops/pallas_knn.py::pallas_knn_select`. On CUDA
tensors `knn_select` launches `csrc/knn_select.cu`; on CPU tensors it runs
`knn_select_plain`, the plain PyTorch version of the same function, which is
also what `chip_smoke.py` holds the kernel against on the card. The kernel
has three paths (`path_for`): for rows of at most `MAX_ROW` = 512
candidates, by K (`route_for`), the run path for K <= 16 (a block stages the
table row of each run of consecutive slots in shared memory once, four lanes
per slot keep register top-K lists that merge with shuffles) and the warp
path for larger K (a warp per slot, K shuffle reductions); for wider rows
(QP > 512, the ScanNet and Tanks-and-Temples presets' P = 26-32) the wide
path at any K: for K <= 32 two passes, the first listing each tile's
selecting slots (and padding the others), the second giving every warp of
the card an equal share of them, a warp per slot with the row in
registers, cut to the candidates that can enter and merged into a top-K
kept in registers; for larger K a warp per slot streams the row in chunks
of 512 merged into a running list in device memory (the output and a
[C, K] scratch pair). Both take one scratch buffer, of the size the
kernel's library gives (`scratch_bytes`). All give the plain version's
bits.

Contract (both versions): nbr_xyz [D, 3*QP] f32 coordinate-major rows,
nbr_pid [D, QP] i32, dslot [C] i32 (row per slot, -1 none), centers [C, 3]
f32, ok [C] bool. Returns (pid [C, K] i32, -1 invalid; d2 [C, K] f32, inf
invalid): ascending d2, ties to the lowest candidate lane. A candidate is
dead when x >= 1e7 and out of reach when d2 > r2 (r2 > 0 only).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

DEAD = 1.0e7
# slots per block of the kernel's run path (csrc/knn_select.cu kSlots)
SLOTS_PER_BLOCK = 64
ROUTES = ("runs", "warp", "wide")
# the most candidates a row of the run and warp paths holds; wider rows take
# the wide path (csrc/knn_select.cu kMaxRow)
MAX_ROW = 512


def route_for(K: int) -> int:
    """The kernel's code for K: the register top-K's capacity of the run
    paths (8 or 16, at least K), or 0 for the warp kernels (any K <= QP)."""
    return 8 if K <= 8 else 16 if K <= 16 else 0


def path_for(K: int, QP: int) -> str:
    """The path a launch takes, as counted in `launches_by_route`."""
    if QP > MAX_ROW:
        return "wide"
    return "runs" if route_for(K) else "warp"


def knn_select_plain(nbr_xyz, nbr_pid, dslot, centers, ok, K: int,
                     r2: float):
    C = centers.shape[0]
    QP = nbr_pid.shape[1]
    dsc = dslot.clamp(min=0).long()
    row = nbr_xyz[dsc].view(C, 3, QP)
    dx = row[:, 0] - centers[:, 0:1]
    dy = row[:, 1] - centers[:, 1:2]
    dz = row[:, 2] - centers[:, 2:3]
    d2 = dx * dx + dy * dy + dz * dz                      # [C, QP]
    good = (ok & (dslot >= 0))[:, None] & (row[:, 0] < DEAD)
    if r2 > 0:
        good = good & (d2 <= r2)
    d2 = torch.where(good, d2, torch.full_like(d2, float("inf")))
    top_d2, top_i = torch.sort(d2, dim=1, stable=True)
    top_d2, top_i = top_d2[:, :K], top_i[:, :K]
    pid = nbr_pid[dsc].gather(1, top_i)
    fin = torch.isfinite(top_d2)
    return (torch.where(fin, pid, -1).to(torch.int32),
            torch.where(fin, top_d2, float("inf")))


def _lib():
    """The library's (launch, scratch size) functions."""
    lib = _build.load("knn_select")
    f, need = lib.knn_select_launch, lib.knn_select_scratch_bytes
    if f.argtypes is None:
        vp = ctypes.c_void_p
        f.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_int, vp, vp, vp,
                      ctypes.c_longlong, vp]
        f.restype = ctypes.c_int
        need.argtypes = [ctypes.c_int] * 3
        need.restype = ctypes.c_longlong
    return f, need


def scratch_bytes(C: int, QP: int, K: int) -> int:
    """The scratch a launch over C slots of QP candidates at K needs, as the
    kernel counts it (csrc/knn_select.cu knn_select_scratch_bytes): on the
    wide path the first pass's slot lists and counts, or past K = 32 a
    [C, K] pid / d2 pair; none for rows of at most MAX_ROW."""
    return int(_lib()[1](C, QP, K))


def _check(nbr_xyz, nbr_pid, dslot, centers, ok, K):
    dev = centers.device
    D, QP = nbr_pid.shape
    C = centers.shape[0]
    for name, t, dt, shape in (
            ("nbr_xyz", nbr_xyz, torch.float32, (D, 3 * QP)),
            ("nbr_pid", nbr_pid, torch.int32, (D, QP)),
            ("dslot", dslot, torch.int32, (C,)),
            ("centers", centers, torch.float32, (C, 3)),
            ("ok", ok, torch.bool, (C,))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"knn_select: {name} must be a contiguous {dt} {shape} tensor "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not 0 < K <= QP:
        raise ValueError(f"knn_select: needs 0 < K <= QP, got K={K} QP={QP}")


def knn_select(nbr_xyz, nbr_pid, dslot, centers, ok, K: int, r2: float):
    """K nearest table candidates per shading slot (see module docstring)."""
    _check(nbr_xyz, nbr_pid, dslot, centers, ok, K)
    if centers.device.type == "cpu":
        return knn_select_plain(nbr_xyz, nbr_pid, dslot, centers, ok, K, r2)
    C, QP = centers.shape[0], nbr_pid.shape[1]
    pid = torch.empty((C, K), dtype=torch.int32, device=centers.device)
    d2 = torch.empty((C, K), dtype=torch.float32, device=centers.device)
    p = _build.ptr
    route, path = route_for(K), path_for(K, QP)
    launch, need = _lib()
    nb = int(need(C, QP, K))
    scratch = (torch.empty(nb, dtype=torch.uint8, device=centers.device)
               if nb else None)
    err = launch(p(nbr_xyz), p(nbr_pid), p(dslot), p(centers),
                 p(ok.view(torch.uint8)), C, QP, K, float(r2), route, p(pid),
                 p(d2), None if scratch is None else p(scratch), nb,
                 _build.stream_handle(centers.device))
    _build.check(err, "knn_select")
    knn_select.launches += 1
    knn_select.launches_by_route[path] += 1
    return pid, d2


knn_select.launches = 0
knn_select.launches_by_route = dict.fromkeys(ROUTES, 0)
