"""K1 past 512 candidates a row, where the card takes the wide path: the
port's K1 on CPU tensors (its plain version, which the wide path on the
card is held to bit for bit) against JAX's pallas_knn_select in interpret
mode, at QP = 513, 702 (scene241), 864 (tt/family), 1,080 and 2,048 (past
the kernel's register cap of 34 candidates a lane), for K = 8 and K = 24
(and 32, the largest register list, at 2,048). Each case plants exact d2
ties on both sides of every 512-candidate edge (the K > 32 kernel's
chunks), of the lane and register edges (candidates 31 / 32 / 33), of 768
(the 24-a-lane kernel's row) and of 1,088 (the 34-a-lane kernel's chunk),
dead candidates, an all-dead row, invalid centers and -1 slots, and runs
with and without a tight radius cut. Neighbor ids and the -1 / inf padding
are equal; every squared distance equals the unfused float32 sum dx*dx +
dy*dy + dz*dz (numpy), as the kernel computes it, and lies within 2 ulp of
JAX's, which XLA contracts into multiply-adds on the CPU (ROADMAP Queue 3,
Watch).

The wrapper's launch arguments (the scratch it allocates at the size the
kernel's library asks, the route code, the launch counts) are read on a
faked card; the kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.ops.pallas_knn import pallas_knn_select
from pointnerf_tpu_torch.ops import knn_select as tk
from pointnerf_tpu_torch.ops.knn_select import (knn_select, knn_select_plain,
                                                path_for)
from test_torch_render import interpret_pallas  # noqa: F401

D, C = 7, 64


def _case(QP, seed):
    """Table rows [D, QP, 3], pids, slots in runs of one row, centers near
    their row's candidates."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(-0.2, 0.2, size=(D, QP, 3)).astype(np.float32)
    # ties across each chunk edge: the candidates just before the edge
    # copied to just after it, and the row's first ones past those
    for edge in range(512, QP, 512):
        n = min(8, QP - edge)
        base[:, edge:edge + n] = base[:, edge - n:edge]
        m = min(8, QP - edge - n)
        base[:, edge + n:edge + n + m] = base[:, :m]
    # the kernel's lane and register edges, its 24-a-lane row edge and its
    # 34-a-lane chunk edge
    base[:, 31:34] = base[:, 0:1]
    for edge in (768, 1088):
        if edge + 8 <= QP:
            base[:, edge - 8:edge + 8] = base[:, 40:56]
    base[:, :, 0][rng.rand(D, QP) < 0.3] = 1.0e8          # dead candidates
    base[3, :, 0] = 1.0e8                                  # an all-dead row
    dslot = np.repeat(rng.randint(0, D, size=8), 8).astype(np.int32)
    dslot[:8] = 3
    dslot[rng.rand(C) < 0.08] = -1
    ok = rng.rand(C) > 0.1
    pid = np.stack([rng.permutation(10 ** 6)[:QP] for _ in range(D)]
                   ).astype(np.int32)
    centers = (base[np.maximum(dslot, 0), rng.randint(0, QP, size=C)]
               + rng.normal(0, 0.03, size=(C, 3))).astype(np.float32)
    centers[:, 0] = np.where(centers[:, 0] > 1e7, 0.0, centers[:, 0])
    return base, pid, dslot, centers, ok


def _winner_lanes(pt, pid, dslot):
    """The candidate lane of each winner (pids are drawn without repeats
    in a row here, so a pid names its lane); 0 for padding."""
    lanes = np.zeros(pt.shape, np.int64)
    for c in range(pt.shape[0]):
        row = pid[max(dslot[c], 0)]
        for k, p in enumerate(pt[c]):
            if p >= 0:
                lanes[c, k] = int(np.nonzero(row == p)[0][0])
    return lanes


@pytest.mark.parametrize("QP,K", [(qp, k) for qp in (513, 702, 864, 1080)
                                  for k in (8, 24)] + [(2048, 8), (2048, 32)])
def test_wide_rows_match_pallas(interpret_pallas, QP, K):
    assert path_for(K, QP) == "wide"
    base, pid, dslot, centers, ok = _case(QP, QP + K)
    flat = np.concatenate([base[..., 0], base[..., 1], base[..., 2]], axis=1)
    args = [torch.from_numpy(a) for a in (flat, pid, dslot, centers, ok)]
    sel = ok & (dslot >= 0)
    for r2 in (0.0, 0.004):
        pj, dj = pallas_knn_select(jnp.asarray(base[np.maximum(dslot, 0)]),
                                   jnp.asarray(pid[np.maximum(dslot, 0)]),
                                   jnp.asarray(centers), jnp.asarray(sel),
                                   K=K, r2=r2)
        pt, dt = knn_select(*args, K=K, r2=r2)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        dj = np.asarray(dj)
        fin = np.isfinite(dj)
        np.testing.assert_array_equal(np.isfinite(dt.numpy()), fin)
        np.testing.assert_array_max_ulp(dt.numpy()[fin], dj[fin], maxulp=2)
        # the unfused sum at the winners
        row = base[np.maximum(dslot, 0)]                     # [C, QP, 3]
        win = row[np.arange(C)[:, None], np.asarray(_winner_lanes(
            pt.numpy(), pid, dslot))]                         # [C, K, 3]
        d = win - centers[:, None, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
            + d[..., 2] * d[..., 2]
        np.testing.assert_array_equal(dt.numpy()[fin], d2[fin])
        pp, dp = knn_select_plain(*args, K, r2)
        assert torch.equal(pp, pt) and torch.equal(dp, dt)
        pt = pt.numpy()
        assert (pt[~sel] == -1).all() and (pt[dslot == 3] == -1).all()
        full = (pt >= 0).sum(1)[sel & (dslot != 3)]
        if r2:                      # the cut leaves rows short
            assert (full < K).any() and full.max() > 0
        else:
            assert (full == K).all()


class _FakeLaunch:
    """knn_select_launch on a faked card: records its arguments."""
    argtypes = restype = None

    def __init__(self):
        self.calls = []

    def __call__(self, *a):
        self.calls.append(a)
        return 0


@pytest.mark.parametrize("K,QP,C,path,scratch", [
    (8, 702, 300, "wide", 1548), (24, 1080, 221184, "wide", 891648),
    (33, 702, 300, "wide", 79200), (8, 512, 300, "runs", 0),
    (17, 243, 300, "warp", 0),
    (32, 2048, 128 * 11000 + 1, "wide", 5655028)])
def test_wide_launch_arguments_on_a_faked_card(monkeypatch, K, QP, C, path,
                                               scratch):
    """The wrapper on a faked card (meta tensors, the library recorded):
    it asks the library's knn_select_scratch_bytes for (C, QP, K), passes
    a buffer of that many bytes (none where it answers 0) and its size, the
    route code route_for(K), and counts the launch on its path."""
    fake = _FakeLaunch()
    asked = []

    def need(*a):
        asked.append(a)
        return scratch
    monkeypatch.setattr(tk, "_lib", lambda: (fake, need))
    monkeypatch.setattr(tk._build, "stream_handle", lambda dev: None)
    D = 5
    m = torch.device("meta")
    args = (torch.empty((D, 3 * QP), device=m),
            torch.empty((D, QP), dtype=torch.int32, device=m),
            torch.empty((C,), dtype=torch.int32, device=m),
            torch.empty((C, 3), device=m),
            torch.empty((C,), dtype=torch.bool, device=m))
    n = dict(knn_select.launches_by_route)
    pid, d2 = knn_select(*args, K=K, r2=0.004)
    assert pid.shape == (C, K) and d2.shape == (C, K)
    assert pid.dtype == torch.int32 and d2.dtype == torch.float32
    assert asked == [(C, QP, K)] and tk.scratch_bytes(C, QP, K) == scratch
    (call,) = fake.calls
    assert call[5:10] == (C, QP, K, pytest.approx(0.004), tk.route_for(K))
    assert call[13] == scratch and (call[12] is not None) == (scratch > 0)
    assert knn_select.launches_by_route[path] == n[path] + 1
