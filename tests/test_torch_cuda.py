"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes (chip_smoke.py checks them at the main path's shapes).
Needs an NVIDIA Hopper card and nvcc: marked `cuda`, skipped without a card.
Run on the card with
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py` (the
repo conftest imports JAX, which the card host does not need)."""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

# chip_smoke.py's bf16 bars for K3 and K4: mean |kernel - plain| /
# mean |plain| of each output or gradient
K3_BF16_TOL = 1e-4
K4_BF16_TOL = 5e-3


def _mean_rel(a, b):
    den = float(b.abs().mean())
    num = float((a - b).abs().mean())
    return num / den if den > 0 else num


def _max_within(a, b, ref):
    """chip_smoke.py's bar on the largest error of a bf16 output or
    gradient `a` against the plain version `b`: at most twice the largest
    distance of `ref` (the plain version summed in f64) from `b`, plus the
    f32 route's bar (2e-4 of max|b|) for a sum in another order."""
    return float((a - b).abs().max()) <= (
        2.0 * float((ref - b).abs().max()) + 2e-4 * float(b.abs().max()))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_knn_select_kernel_matches_plain(dev):
    from pointnerf_tpu_torch.ops.knn_select import knn_select, knn_select_plain
    g = torch.Generator().manual_seed(0)
    D, QP, C, K = 50, 243, 1001, 8
    base = torch.rand((D, 3, QP), generator=g) * 0.2
    base[:, :, 100:110] = base[:, :, 0:10]          # exact ties
    base[:, 0, 200:] = 1.0e8                          # dead entries
    flat = base.reshape(D, 3 * QP).to(dev)
    pid = torch.randint(0, 10 ** 6, (D, QP), generator=g,
                        dtype=torch.int32).to(dev)
    dslot = torch.randint(-1, D, (C,), generator=g, dtype=torch.int32).to(dev)
    centers = (torch.rand((C, 3), generator=g) * 0.2).to(dev)
    ok = (torch.rand(C, generator=g) > 0.1).to(dev)
    for r2 in (0.0, 0.004):
        pk, dk = knn_select(flat, pid, dslot, centers, ok, K=K, r2=r2)
        pp, dp = knn_select_plain(flat, pid, dslot, centers, ok, K, r2)
        torch.cuda.synchronize()
        assert torch.equal(pk, pp) and torch.equal(dk, dp)


def _run_inputs(QP, seed=0, D=60, C=1500):
    """K1 inputs in the main path's order: slots in sorted runs of equal
    row (lengths 1-100; the first run crosses the block boundary at slot
    128), some ok = 0 and dslot = -1 slots inside runs, exact d2 ties, dead
    entries and one all-dead row (row 5) read by a run."""
    rng = np.random.RandomState(seed)
    base = (rng.rand(D, 3, QP) * 0.2).astype(np.float32)
    base[:, :, 100:110] = base[:, :, 0:10]           # exact ties
    base[:, 0][rng.rand(D, QP) < 0.3] = 1.0e8         # dead entries
    base[5, 0] = 1.0e8                                 # an all-dead row
    lengths, rows = [60, 120], [7, 5]
    while sum(lengths) < C:
        lengths.append(rng.randint(1, 101))
        rows.append(rng.randint(0, D))
    dslot = np.repeat(rows, lengths)[:C].astype(np.int32)
    dslot[rng.rand(C) < 0.03] = -1                     # -1 inside runs
    ok = rng.rand(C) > 0.05                            # ok = 0 inside runs
    ok[-40:] = False                                   # an invalid tail
    centers = (rng.rand(C, 3) * 0.2).astype(np.float32)
    pid = rng.randint(0, 10 ** 6, size=(D, QP)).astype(np.int32)
    return [torch.from_numpy(a) for a in
            (base.reshape(D, 3 * QP), pid, dslot, centers, ok)]


def _hold_k1(dev, args, K, r2):
    from pointnerf_tpu_torch.ops.knn_select import (knn_select,
                                                    knn_select_plain,
                                                    path_for)
    args = [a.to(dev) for a in args]
    route = path_for(K, args[1].shape[1])
    n = dict(knn_select.launches_by_route)
    pk, dk = knn_select(*args, K=K, r2=r2)
    pp, dp = knn_select_plain(*args, K, r2)
    torch.cuda.synchronize()
    assert knn_select.launches_by_route[route] == n[route] + 1
    assert torch.equal(pk, pp) and torch.equal(dk, dp)
    return pk


@pytest.mark.parametrize("QP", [243, 300, 512])
@pytest.mark.parametrize("K", [1, 8, 16, "QP"])
def test_knn_select_runs_match_plain(dev, QP, K):
    """Both kernel paths (run path for K <= 16, warp path above) bit-equal
    to the plain version on sorted runs of shared rows, with and without
    the r2 cut."""
    K = QP if K == "QP" else K
    args = _run_inputs(QP, seed=QP + K)
    for r2 in (0.0, 0.004):
        pk = _hold_k1(dev, args, K, r2)
        assert bool((pk >= 0).any())
        # the run on the all-dead row selects nothing
        assert bool((pk[60:180][(args[2][60:180] == 5).to(dev)] == -1).all())


def test_knn_select_runs_overflow_the_pool(dev):
    """Blocks whose runs hold more live candidates than the shared pool
    (every slot its own row of 512 live candidates) stage in rounds."""
    args = _run_inputs(512, seed=3, D=300, C=700)
    args[0].view(300, 3, 512)[:, 0] = torch.rand((300, 512)) * 0.2
    args[2][:] = torch.arange(700, dtype=torch.int32) % 300
    args[4][:] = True
    _hold_k1(dev, args, 8, 0.0)


def _wide_inputs(QP, seed=0, D=60, C=1500):
    """`_run_inputs` at a row wider than 512 candidates, with exact d2 ties
    planted across the 512-candidate chunk edges (candidates 0-15 copied
    to 505-520, as many as the row holds, and past 1,036 to 1,020-1,035)
    and a dense row (row 7, every candidate live) read by the first run."""
    args = _run_inputs(QP, seed=seed, D=D, C=C)
    g = torch.Generator().manual_seed(seed)
    base = args[0].view(D, 3, QP)
    n = min(16, QP - 505)
    base[:, :, 505:505 + n] = base[:, :, 0:n]
    if QP > 1036:
        base[:, :, 1020:1036] = base[:, :, 0:16]
    base[7] = torch.rand((3, QP), generator=g) * 0.2
    return args


@pytest.mark.parametrize("QP", [513, 702, 810, 864, 1080])
@pytest.mark.parametrize("K", [1, 8, 16, 17, 24, "QP"])
def test_knn_select_wide_matches_plain(dev, QP, K):
    """The wide path (QP > 512: a warp per slot, its list in device memory
    across the 512-candidate chunks) bit-equal to the plain version, with
    and without the r2 cut, ties across chunk edges, dead and invalid
    slots, an all-dead row and a dense one."""
    K = QP if K == "QP" else K
    args = _wide_inputs(QP, seed=QP + K)
    for r2 in (0.0, 0.004):
        pk = _hold_k1(dev, args, K, r2)
        assert bool((pk >= 0).any())
        assert bool((pk[60:180][(args[2][60:180] == 5).to(dev)] == -1).all())


@pytest.mark.parametrize("SR", [1, 31, 80, 129])
@pytest.mark.parametrize("C", [1, 3, 8])
def test_fused_march_kernel_matches_plain(dev, SR, C):
    """R = 333 rays (not a multiple of the 8-ray tile), some rays all
    invalid, some whose transmittance underflows (sigma * dist >= 100)."""
    from pointnerf_tpu_torch.ops.fused_march import (fused_march,
                                                     fused_march_plain)
    g = torch.Generator().manual_seed(SR * 10 + C)
    R = 333
    dist = torch.rand((R, SR), generator=g) * 0.1
    valid = torch.rand((R, SR), generator=g) > 0.3
    feats = torch.rand((R, SR, C + 1), generator=g)
    valid[:20] = False                                # all-invalid rays
    feats[20:40, :, 0] = 2000.0                       # sigma * dist >= 100
    dist[20:40] = 0.05 + dist[20:40]
    valid[20:40] = True
    bg = torch.rand((C,), generator=g)
    ins = [t.to(dev) for t in (dist, valid, feats, bg)]
    outs = fused_march(*ins)
    for a, b in zip(outs, fused_march_plain(*ins)):
        assert float((a - b).abs().max()) <= 1e-5
    bgtr = outs[2]
    assert bool((bgtr[:20] == 1.0).all())
    assert bool((bgtr[20:40] <= 1e-10).all())


@pytest.mark.parametrize("SR", [16, 80, 160])
@pytest.mark.parametrize("C", [9, 16, 128])
def test_fused_march_wide_kernel_matches_plain(dev, SR, C):
    """The wide kernel (C > MAX_C: a warp per ray) against the plain march
    bit for bit, R = 333 (not a multiple of the block's 4 rays), with
    all-invalid rays and rays whose transmittance underflows; the launch
    takes the wide route."""
    _wide_kernel_matches_plain(dev, SR, C)


@pytest.mark.parametrize("SR,C", [(2000, 8), (3000, 3)])
def test_fused_march_wide_kernel_at_few_channels(dev, SR, C):
    """C <= MAX_C with no tile of rays that fits in shared memory: the
    launch takes the wide kernel, bit for bit the plain march."""
    from pointnerf_tpu_torch.ops.fused_march import rays_per_block, route
    assert rays_per_block(SR, C) == 0 and route(SR, C) == "wide"
    _wide_kernel_matches_plain(dev, SR, C)


def _wide_kernel_matches_plain(dev, SR, C):
    from pointnerf_tpu_torch.ops.fused_march import (fused_march,
                                                     fused_march_plain)
    g = torch.Generator().manual_seed(SR * 1000 + C)
    R = 333
    dist = torch.rand((R, SR), generator=g) * 0.1
    valid = torch.rand((R, SR), generator=g) > 0.3
    feats = torch.randn((R, SR, C + 1), generator=g)
    feats[..., 0] = feats[..., 0].abs() * 5
    valid[:20] = False
    feats[20:40, :, 0] = 2000.0
    dist[20:40] = 0.05 + dist[20:40]
    valid[20:40] = True
    bg = torch.rand((C,), generator=g)
    ins = [t.to(dev) for t in (dist, valid, feats, bg)]
    before = dict(fused_march.launches_by_route)
    outs = fused_march(*ins)
    assert fused_march.launches_by_route["wide"] == before["wide"] + 1
    assert fused_march.launches_by_route["tiled"] == before["tiled"]
    for a, b in zip(outs, fused_march_plain(*ins)):
        assert torch.equal(a, b)
    assert bool((outs[2][:20] == 1.0).all())


def test_fused_march_tile_of_four_rays(dev):
    """SR * (C + 2) too wide for an 8-ray tile: the launch takes 4 rays."""
    from pointnerf_tpu_torch.ops.fused_march import (fused_march,
                                                     fused_march_plain,
                                                     rays_per_block)
    R, SR, C = 37, 1000, 8
    assert rays_per_block(SR, C) == 4
    g = torch.Generator().manual_seed(7)
    ins = [(torch.rand((R, SR), generator=g) * 0.01).to(dev),
           (torch.rand((R, SR), generator=g) > 0.3).to(dev),
           torch.rand((R, SR, C + 1), generator=g).to(dev),
           torch.rand((C,), generator=g).to(dev)]
    for a, b in zip(fused_march(*ins), fused_march_plain(*ins)):
        assert float((a - b).abs().max()) <= 1e-5


def test_fused_march_refuses_misaligned_feats(dev):
    from pointnerf_tpu_torch.ops.fused_march import fused_march
    R, SR, C = 8, 5, 3
    flat = torch.rand(R * SR * (C + 1) + 1, device=dev)
    feats = flat[1:].view(R, SR, C + 1)               # 4-byte aligned only
    with pytest.raises(ValueError, match="16-byte"):
        fused_march(torch.rand((R, SR), device=dev),
                    torch.ones((R, SR), dtype=torch.bool, device=dev), feats,
                    torch.rand((C,), device=dev))


def test_k1_k2_launches_make_no_host_sync(dev):
    from pointnerf_tpu_torch.ops.fused_march import fused_march
    from pointnerf_tpu_torch.ops.knn_select import knn_select
    k1 = [a.to(dev) for a in _run_inputs(243)]
    g = torch.Generator().manual_seed(8)
    k2 = [(torch.rand((64, 80), generator=g) * 0.1).to(dev),
          (torch.rand((64, 80), generator=g) > 0.3).to(dev),
          torch.rand((64, 80, 4), generator=g).to(dev),
          torch.rand((3,), generator=g).to(dev)]
    for K in (8, 16, 243):                        # build and load first
        knn_select(*k1, K=K, r2=0.004)
    fused_march(*k2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for K in (8, 16, 243):
            knn_select(*k1, K=K, r2=0.004)
        fused_march(*k2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("bf16", [False, True])
def test_fused_decode_kernel_matches_plain(dev, bf16):
    from pointnerf_tpu_torch.config import bench_config
    from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
    from pointnerf_tpu_torch.ops.fused_decode import (DecodeSpec,
                                                      fused_decode,
                                                      fused_decode_plain)
    cfg = bench_config()
    params = init_aggregator_params(cfg.agg, torch.Generator().manual_seed(2),
                                    device=dev)
    spec = DecodeSpec(Fi=32, Dd=6, E=7, Ff=3, Fd=5, H=256, K=8, L1=2, L3=2,
                      neg_slope=0.01, bf16=bf16)
    M = 8 * 301                                      # a ragged last tile
    rng = np.random.RandomState(3)
    feat, dists, extras = (torch.from_numpy(rng.normal(
        0, s, (M, n)).astype(np.float32)).to(dev)
        for s, n in ((0.5, 32), (0.05, 6), (0.5, 7)))
    w = torch.from_numpy(rng.rand(M, 1).astype(np.float32)).to(dev)
    fk, ak = fused_decode(feat, dists, extras, w, params, spec)
    fp, ap = fused_decode_plain(feat, dists, extras, w, params, spec)
    f64, a64 = fused_decode_plain(feat, dists, extras, w, params, spec,
                                  dtype=torch.float64)
    torch.cuda.synchronize()
    # chip_smoke.py's bars: in f32 relative to the output's scale; in bf16
    # on the mean error (a sum in another order moves a few elements by a
    # bf16 step), where both versions round at the same places and stay far
    # closer than the f32 plain version does to the bf16 one, and on the
    # largest error against the f64-summed plain version's
    if bf16:
        assert _mean_rel(fk, fp) <= K3_BF16_TOL
        assert _mean_rel(ak, ap) <= K3_BF16_TOL
        assert _max_within(fk, fp, f64) and _max_within(ak, ap, a64)
    else:
        scale = max(float(fp.abs().max()), float(ap.abs().max()))
        assert float((fk - fp).abs().max()) <= 2e-4 * scale
        assert float((ak - ap).abs().max()) <= 2e-4 * scale


@pytest.mark.parametrize("bf16", [False, True])
def test_fused_decode_bwd_kernel_matches_plain(dev, bf16):
    """K4 against its plain version on every gradient (rows, then each
    dW/db), and the autograd Function launching K3 forward and K4 backward."""
    from pointnerf_tpu_torch.config import bench_config
    from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
    from pointnerf_tpu_torch.ops.fused_decode import (DecodeSpec,
                                                      fused_decode,
                                                      fused_decode_bwd,
                                                      fused_decode_bwd_plain)
    from pointnerf_tpu_torch.train.optim import tree_leaves, tree_map
    cfg = bench_config()
    params = init_aggregator_params(cfg.agg, torch.Generator().manual_seed(4),
                                    device=dev)
    params = {k: params[k] for k in ("block1", "block3", "alpha")}
    spec = DecodeSpec(Fi=32, Dd=6, E=7, Ff=3, Fd=5, H=256, K=8, L1=2, L3=2,
                      neg_slope=0.01, bf16=bf16)
    M = 8 * 301                                      # a ragged last tile
    rng = np.random.RandomState(5)
    feat, dists, extras, gf = (torch.from_numpy(rng.normal(
        0, s, shape).astype(np.float32)).to(dev)
        for s, shape in ((0.5, (M, 32)), (0.05, (M, 6)), (0.5, (M, 7)),
                         (1.0, (M // 8, 256))))
    w = torch.from_numpy((rng.rand(M, 1) * (rng.rand(M, 1) > 0.3)).astype(
        np.float32)).to(dev)
    ga = torch.from_numpy(rng.normal(0, 1, (M // 8, 1)).astype(
        np.float32)).to(dev)
    gk = tree_leaves(fused_decode_bwd(feat, dists, extras, w, params, spec,
                                      gf, ga))
    gp = tree_leaves(fused_decode_bwd_plain(feat, dists, extras, w, params,
                                            spec, gf, ga))
    g64 = tree_leaves(fused_decode_bwd_plain(feat, dists, extras, w, params,
                                             spec, gf, ga,
                                             dtype=torch.float64))
    torch.cuda.synchronize()
    # chip_smoke.py's bars: f32 relative to each gradient's max|plain|, bf16
    # on each gradient's mean error and its largest error
    for a, b, ref in zip(gk, gp, g64):
        if bf16:
            assert _mean_rel(a, b) <= K4_BF16_TOL
            assert _max_within(a, b, ref)
        else:
            assert float((a - b).abs().max()) <= 2e-4 * float(b.abs().max())

    xs = [t.clone().requires_grad_() for t in (feat, dists, extras, w)]
    p = tree_map(lambda t: t.clone().requires_grad_(), params)
    n3, n4 = fused_decode.launches, fused_decode_bwd.launches
    f, a = fused_decode(*xs, p, spec)
    got = torch.autograd.grad((f * gf).sum() + (a * ga).sum(),
                              xs + tree_leaves(p))
    assert (fused_decode.launches, fused_decode_bwd.launches) == (n3 + 1,
                                                                  n4 + 1)
    for a, b in zip(got, gk):
        assert torch.equal(a, b)


# the bf16 route: the tensor-core kernels (csrc/fused_decode_tc.cu,
# csrc/fused_decode_bwd_tc.cu)
TC_CASES = {
    # bench_config's widths, M not a multiple of either tile
    "bench": dict(H=256, L1=2, L3=2, M=8 * 301),
    # a second width the envelope takes, one layer per block
    "h128": dict(H=128, L1=1, L3=1, M=8 * 170),
}


def _tc_inputs(dev, H, L1, L3, M, seed=6, dead_from=None, live_grad=False):
    """Decode inputs, weights and upstream gradients at bench_config's
    channel widths. dead_from: groups from there on get w == 0 and zero
    g_fagg / g_alpha (the main path's padding tail); live_grad: those
    groups keep their upstream gradients (only w is zero)."""
    from pointnerf_tpu_torch.ops.fused_decode import DecodeSpec
    spec = DecodeSpec(Fi=32, Dd=6, E=7, Ff=3, Fd=5, H=H, K=8, L1=L1, L3=L3,
                      neg_slope=0.01, bf16=True)
    rng = np.random.RandomState(seed)
    ins = [rng.normal(0, s, (M, n)).astype(np.float32)
           for s, n in ((0.5, 32), (0.05, 6), (0.5, 7))]
    w = (rng.rand(M, 1) * (rng.rand(M, 1) > 0.3)).astype(np.float32)
    G = M // 8
    gf = rng.normal(0, 1, (G, H)).astype(np.float32)
    ga = rng.normal(0, 1, (G, 1)).astype(np.float32)
    if dead_from is not None:
        w[dead_from * 8:] = 0.0
        if not live_grad:
            gf[dead_from:] = 0.0
            ga[dead_from:] = 0.0
    g = torch.Generator().manual_seed(seed)

    def dense(n_in):
        return {"w": (torch.randn((n_in, H), generator=g)
                      * (2.0 / n_in) ** 0.5).to(dev),
                "b": (torch.randn((H,), generator=g) * 0.1).to(dev)}
    from pointnerf_tpu_torch.ops.fused_decode import layer_inputs
    dims = layer_inputs(spec)
    params = {"block1": [dense(n) for n in dims[:L1]],
              "block3": [dense(n) for n in dims[L1:]],
              "alpha": [{"w": (torch.randn((H, 1), generator=g)
                               * 0.1).to(dev),
                         "b": torch.zeros((1,)).to(dev)}]}
    t = [torch.from_numpy(a).to(dev) for a in ins + [w]]
    return (t, params, spec, torch.from_numpy(gf).to(dev),
            torch.from_numpy(ga).to(dev))


def _hold_tc(dev, ins, params, spec, gf, ga):
    """K3 and K4 on the tensor-core route against their plain versions at
    chip_smoke.py's bars; returns the kernels' outputs."""
    from pointnerf_tpu_torch.ops import fused_decode as fd
    from pointnerf_tpu_torch.train.optim import tree_leaves
    n3 = dict(fd.fused_decode.launches_by_route)
    n4 = dict(fd.fused_decode_bwd.launches_by_route)
    fk = fd.fused_decode(*ins, params, spec)
    gk = fd.fused_decode_bwd(*ins, params, spec, gf, ga)
    assert fd.fused_decode.launches_by_route["tensor_core"] == \
        n3["tensor_core"] + 1
    assert fd.fused_decode_bwd.launches_by_route["tensor_core"] == \
        n4["tensor_core"] + 1
    assert fd.fused_decode.launches_by_route["cuda_core"] == n3["cuda_core"]
    fp = fd.fused_decode_plain(*ins, params, spec)
    gp = fd.fused_decode_bwd_plain(*ins, params, spec, gf, ga)
    f64 = fd.fused_decode_plain(*ins, params, spec, dtype=torch.float64)
    g64 = fd.fused_decode_bwd_plain(*ins, params, spec, gf, ga,
                                    dtype=torch.float64)
    torch.cuda.synchronize()
    for a, b, ref in zip(fk, fp, f64):
        assert _mean_rel(a, b) <= K3_BF16_TOL
        assert _max_within(a, b, ref)
    for a, b, ref in zip(tree_leaves(gk), tree_leaves(gp), tree_leaves(g64)):
        assert _mean_rel(a, b) <= K4_BF16_TOL
        assert _max_within(a, b, ref)
    return fk, gk


@pytest.mark.parametrize("case", sorted(TC_CASES))
def test_tc_decode_matches_plain(dev, case):
    _hold_tc(dev, *_tc_inputs(dev, **TC_CASES[case]))


@pytest.mark.parametrize("case", sorted(TC_CASES))
def test_tc_decode_dead_tiles_are_zero(dev, case):
    """The padding tail (w == 0, zero upstream gradients) gives exactly 0
    in every output row it owns and in no parameter gradient."""
    c = TC_CASES[case]
    G = c["M"] // 8
    ins, params, spec, gf, ga = _tc_inputs(dev, **c, dead_from=G // 3)
    (fagg, alpha), (g_feat, g_dists, g_extras, g_w, _gp) = _hold_tc(
        dev, ins, params, spec, gf, ga)
    g0 = G // 3
    assert not bool(fagg[g0:].any()) and not bool(alpha[g0:].any())
    for t in (g_feat, g_dists, g_extras, g_w):
        assert not bool(t[g0 * 8:].any())
    assert bool(g_w[:g0 * 8].any())


def test_tc_decode_bwd_live_gradient_without_weight(dev):
    """Tiles whose rows all have w == 0 but whose groups have nonzero
    g_fagg / g_alpha are computed: g_w there matches the plain version and
    is not zero."""
    c = TC_CASES["bench"]
    G = c["M"] // 8
    ins, params, spec, gf, ga = _tc_inputs(dev, **c, dead_from=G // 3,
                                           live_grad=True)
    _f, (_a, _b, g_extras, g_w, _gp) = _hold_tc(dev, ins, params, spec, gf,
                                                ga)
    tail = g_w[(G // 3 + 16) * 8:]
    assert bool(tail.any())
    assert not bool(g_extras[(G // 3 + 16) * 8:].any())


@pytest.mark.parametrize("case", sorted(TC_CASES))
def test_tc_decode_bwd_dw_bit_identical(dev, case):
    """dW, db and every row gradient are the same bits in two calls (fixed
    summation orders, no atomics)."""
    from pointnerf_tpu_torch.ops.fused_decode import fused_decode_bwd
    from pointnerf_tpu_torch.train.optim import tree_leaves
    ins, params, spec, gf, ga = _tc_inputs(dev, **TC_CASES[case])
    a = tree_leaves(fused_decode_bwd(*ins, params, spec, gf, ga))
    b = tree_leaves(fused_decode_bwd(*ins, params, spec, gf, ga))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bf16", [False, True])
def test_decode_launches_make_no_host_sync(dev, bf16):
    """Neither wrapper synchronizes with the host, on either route."""
    from pointnerf_tpu_torch.ops.fused_decode import (fused_decode,
                                                      fused_decode_bwd)
    ins, params, spec, gf, ga = _tc_inputs(dev, **TC_CASES["bench"])
    spec = spec._replace(bf16=bf16)
    fused_decode(*ins, params, spec)             # build and load first
    fused_decode_bwd(*ins, params, spec, gf, ga)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused_decode(*ins, params, spec)
        fused_decode_bwd(*ins, params, spec, gf, ga)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", sorted(TC_CASES))
def test_tc_smem_formulas_match_the_kernels(dev, case):
    from pointnerf_tpu_torch.ops.fused_decode import (tc_bwd_smem_bytes,
                                                      tc_smem_bytes,
                                                      tc_smem_bytes_built)
    _ins, _p, spec, _gf, _ga = _tc_inputs(dev, **TC_CASES[case])
    assert tc_smem_bytes_built(spec) == (tc_smem_bytes(spec),
                                         *tc_bwd_smem_bytes(spec))


def _dense_probe_k1_inputs(rays=96, SR=80, D=40, QP=243, seed=11):
    """K1 inputs in the dense prob-mode layout of a probe chunk: rays x SR
    slots in ray-major order, ~10% selecting (ok = 1) in one run of
    consecutive slots per hit ray, each run stepping through a few rows;
    the other slots have ok = 0 and sit at the origin, whose row is either
    none (-1) or a real one."""
    rng = np.random.RandomState(seed)
    base = (rng.rand(D, 3, QP) * 0.2).astype(np.float32)
    base[:, 0][rng.rand(D, QP) < 0.3] = 1.0e8          # dead entries
    C = rays * SR
    ok = np.zeros(C, bool)
    dslot = np.where(rng.rand(C) < 0.5, -1, 0).astype(np.int32)
    centers = np.zeros((C, 3), np.float32)
    for r in rng.choice(rays, rays // 2, replace=False):
        s0 = r * SR + rng.randint(0, SR - 20)
        n = rng.randint(5, 20)
        ok[s0:s0 + n] = True
        dslot[s0:s0 + n] = np.repeat(rng.randint(0, D, 4), 5)[:n]
        centers[s0:s0 + n] = rng.rand(n, 3) * 0.2
    pid = rng.randint(0, 10 ** 6, size=(D, QP)).astype(np.int32)
    return [torch.from_numpy(a) for a in
            (base.reshape(D, 3 * QP), pid, dslot, centers, ok)]


def test_knn_select_dense_probe_slots_match_plain(dev):
    """K1 bit-equal to its plain version on the dense probe layout, where
    ~90% of the slots do not select."""
    args = _dense_probe_k1_inputs()
    assert 0.05 < float(args[4].float().mean()) < 0.15
    for r2 in (0.0, 0.004):
        pk = _hold_k1(dev, args, 8, r2)
        ok = args[4].to(dev)
        assert bool((pk[~ok] == -1).all()) and bool((pk[ok] >= 0).any())


@pytest.mark.parametrize("bf16", [False, True])
def test_fused_decode_dense_probe_rows_match_plain(dev, bf16):
    """K3 on a dense prob-mode input: rays x SR=80 x K=8 rows, live (a
    nonzero weight) only in one run of slots on a few rays, every other row
    zero as the masked dense decode feeds it. Against the plain version at
    the bars of test_fused_decode_kernel_matches_plain; the groups without
    a live row come out exactly zero."""
    from pointnerf_tpu_torch.config import bench_config
    from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
    from pointnerf_tpu_torch.ops.fused_decode import (DecodeSpec,
                                                      fused_decode,
                                                      fused_decode_plain)
    cfg = bench_config()
    params = init_aggregator_params(cfg.agg, torch.Generator().manual_seed(4),
                                    device=dev)
    spec = DecodeSpec(Fi=32, Dd=6, E=7, Ff=3, Fd=5, H=256, K=8, L1=2, L3=2,
                      neg_slope=0.01, bf16=bf16)
    rays, SR, K = 48, 80, 8
    M = rays * SR * K
    rng = np.random.RandomState(5)
    live = np.zeros((rays, SR), bool)
    for r in (2, 17, 18, 40):
        s0 = rng.randint(0, SR - 16)
        live[r, s0:s0 + rng.randint(4, 16)] = True
    row_live = np.repeat(live.reshape(-1), K) & (rng.rand(M) > 0.2)
    feat, dists, extras = (rng.normal(0, s, (M, n)).astype(np.float32)
                           for s, n in ((0.5, 32), (0.05, 6), (0.5, 7)))
    w = rng.rand(M, 1).astype(np.float32)
    for a in (feat, dists, extras, w):
        a[~row_live] = 0.0
    ins = [torch.from_numpy(a).to(dev) for a in (feat, dists, extras, w)]
    fk, ak = fused_decode(*ins, params, spec)
    fp, ap = fused_decode_plain(*ins, params, spec)
    f64, a64 = fused_decode_plain(*ins, params, spec, dtype=torch.float64)
    torch.cuda.synchronize()
    if bf16:
        assert _mean_rel(fk, fp) <= K3_BF16_TOL
        assert _mean_rel(ak, ap) <= K3_BF16_TOL
        assert _max_within(fk, fp, f64) and _max_within(ak, ap, a64)
    else:
        scale = max(float(fp.abs().max()), float(ap.abs().max()))
        assert float((fk - fp).abs().max()) <= 2e-4 * scale
        assert float((ak - ap).abs().max()) <= 2e-4 * scale
    dead = ~torch.from_numpy(row_live.reshape(-1, K).any(1)).to(dev)
    assert bool((fk[dead] == 0).all()) and bool((ak[dead] == 0).all())
    assert bool((fk[~dead] != 0).any())


# the f32 route: the CUDA-core kernels (csrc/fused_decode.cu,
# csrc/fused_decode_bwd.cu) decode only the live groups of
# csrc/decode_live.cuh. Inputs in the dense layout [R, SR, K] of the
# dataset path, random features on every row (a dead group's outputs must
# be 0 whatever its rows hold).
F32_CASES = ("none", "all", "last_group", "one_per_ray", "sparse")


def _f32_inputs(dev, case, R=24, SR=80, K=8, H=256, L1=2, L3=2, seed=8,
                grad_only=0):
    """(ins, params, spec, g_fagg, g_alpha, live [G] bool). Live groups get
    weights (a few rows of each zero) and upstream gradients; `grad_only`
    dead groups get an upstream gradient without weight."""
    from pointnerf_tpu_torch.ops.fused_decode import DecodeSpec, layer_inputs
    spec = DecodeSpec(Fi=32, Dd=6, E=7, Ff=3, Fd=5, H=H, K=K, L1=L1, L3=L3,
                      neg_slope=0.01, bf16=False)
    rng = np.random.RandomState(seed)
    G = R * SR
    M = G * K
    live = np.zeros(G, bool)
    if case == "all":
        live[:] = True
    elif case == "last_group":
        live[-1] = True
    elif case == "one_per_ray":
        live[np.arange(R) * SR + rng.randint(0, SR, R)] = True
    elif case == "sparse":
        live[rng.rand(G) < 0.02] = True
    w = rng.rand(M, 1).astype(np.float32) + 0.05
    w *= (rng.rand(M, 1) > 0.3)
    w.reshape(G, K)[:, 0] += 0.1          # a live group has a weight
    w.reshape(G, K)[~live] = 0.0
    gf = rng.normal(0, 1, (G, H)).astype(np.float32)
    ga = rng.normal(0, 1, (G, 1)).astype(np.float32)
    with_grad = live.copy()
    if grad_only:
        with_grad[rng.choice(np.flatnonzero(~live), grad_only,
                             replace=False)] = True
    gf[~with_grad] = 0.0
    ga[~with_grad] = 0.0
    ins = [rng.normal(0, s, (M, n)).astype(np.float32)
           for s, n in ((0.5, 32), (0.05, 6), (0.5, 7))] + [w]
    g = torch.Generator().manual_seed(seed)

    def dense(n_in):
        return {"w": (torch.randn((n_in, H), generator=g)
                      * (2.0 / n_in) ** 0.5).to(dev),
                "b": (torch.randn((H,), generator=g) * 0.1).to(dev)}
    dims = layer_inputs(spec)
    params = {"block1": [dense(n) for n in dims[:L1]],
              "block3": [dense(n) for n in dims[L1:]],
              "alpha": [{"w": (torch.randn((H, 1), generator=g)
                               * 0.1).to(dev),
                         "b": torch.zeros((1,)).to(dev)}]}
    return ([torch.from_numpy(a).to(dev) for a in ins], params, spec,
            torch.from_numpy(gf).to(dev), torch.from_numpy(ga).to(dev),
            torch.from_numpy(with_grad).to(dev))


def _hold_f32(ins, params, spec, gf, ga):
    """K3 and K4 on the CUDA-core route against their plain versions at
    chip_smoke.py's f32 bars (2e-4 of each output's or gradient's scale;
    exactly 0 where the plain one is all zero); returns the kernels'
    outputs."""
    from pointnerf_tpu_torch.ops import fused_decode as fd
    from pointnerf_tpu_torch.train.optim import tree_leaves
    n3 = dict(fd.fused_decode.launches_by_route)
    n4 = dict(fd.fused_decode_bwd.launches_by_route)
    fk = fd.fused_decode(*ins, params, spec)
    gk = fd.fused_decode_bwd(*ins, params, spec, gf, ga)
    assert fd.fused_decode.launches_by_route["cuda_core"] == \
        n3["cuda_core"] + 1
    assert fd.fused_decode_bwd.launches_by_route["cuda_core"] == \
        n4["cuda_core"] + 1
    assert fd.fused_decode.launches_by_route["tensor_core"] == \
        n3["tensor_core"]
    fp = fd.fused_decode_plain(*ins, params, spec)
    gp = fd.fused_decode_bwd_plain(*ins, params, spec, gf, ga)
    torch.cuda.synchronize()
    for a, b in list(zip(fk, fp)) + list(zip(tree_leaves(gk),
                                              tree_leaves(gp))):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 2e-4 * float(b.abs().max())
    return fk, gk


@pytest.mark.parametrize("case", F32_CASES)
def test_f32_decode_dead_groups_are_zero(dev, case):
    """Every output a dead group owns is exactly 0 (its rows hold random
    features); the live groups match the plain version."""
    ins, params, spec, gf, ga, live = _f32_inputs(dev, case)
    (fagg, alpha), (g_feat, g_dists, g_extras, g_w, _gp) = _hold_f32(
        ins, params, spec, gf, ga)
    dead = ~live
    assert not bool(fagg[dead].any()) and not bool(alpha[dead].any())
    for t in (g_feat, g_dists, g_extras, g_w):
        assert not bool(t.view(dead.shape[0], spec.K, -1)[dead].any())
    if bool(live.any()):
        assert bool(fagg[live].any()) and bool(g_w.view(-1, spec.K)[live]
                                               .any())


@pytest.mark.parametrize("case", F32_CASES)
def test_f32_live_list_matches_plain(dev, case):
    """The list pass of both kernels alone, K3's rule and K4's, equals
    live_groups_plain bit for bit (ascending group ids)."""
    from pointnerf_tpu_torch.ops.fused_decode import (live_groups,
                                                      live_groups_plain)
    ins, _p, spec, gf, ga, _live = _f32_inputs(dev, case, grad_only=5
                                               if case != "all" else 0)
    w = ins[3]
    got = live_groups(w, spec.K)
    assert torch.equal(got.cpu(), live_groups_plain(w.cpu(), spec.K))
    got4 = live_groups(w, spec.K, gf, ga)
    assert torch.equal(got4.cpu(), live_groups_plain(w.cpu(), spec.K,
                                                     gf.cpu(), ga.cpu()))


def test_f32_decode_bwd_live_gradient_without_weight(dev):
    """Groups whose rows all have w == 0 but whose upstream gradient is
    nonzero are computed: g_w there matches the plain version and is not
    zero, the other row gradients are zero."""
    ins, params, spec, gf, ga, with_grad = _f32_inputs(dev, "sparse",
                                                       grad_only=12)
    _f, (g_feat, _d, g_extras, g_w, _gp) = _hold_f32(ins, params, spec, gf,
                                                     ga)
    K = spec.K
    only = with_grad & ~(ins[3].view(-1, K) != 0).any(1)
    assert int(only.sum()) == 12
    assert bool((g_w.view(-1, K)[only] != 0).all())
    assert not bool(g_extras.view(-1, K, spec.E)[only].any())
    assert not bool(g_feat.view(-1, K, spec.Fi)[only].any())


@pytest.mark.parametrize("case", ["sparse", "all"])
def test_f32_decode_bwd_bit_identical(dev, case):
    """dW, db and every row gradient are the same bits in two calls (fixed
    summation orders, no atomics), and so is the forward."""
    from pointnerf_tpu_torch.ops.fused_decode import (fused_decode,
                                                      fused_decode_bwd)
    from pointnerf_tpu_torch.train.optim import tree_leaves
    ins, params, spec, gf, ga, _l = _f32_inputs(dev, case, R=12)
    for a, b in zip(tree_leaves(fused_decode_bwd(*ins, params, spec, gf, ga)),
                    tree_leaves(fused_decode_bwd(*ins, params, spec, gf,
                                                 ga))):
        assert torch.equal(a, b)
    for a, b in zip(fused_decode(*ins, params, spec),
                    fused_decode(*ins, params, spec)):
        assert torch.equal(a, b)


def test_f32_decode_bwd_in_batches(dev, monkeypatch):
    """With the scratch cut to 3 tiles, K4 takes its live rows in many
    batches (phase B adding to its partials): the same function, the same
    bits in two calls."""
    from pointnerf_tpu_torch.ops import fused_decode as fd
    from pointnerf_tpu_torch.train.optim import tree_leaves
    monkeypatch.setattr(fd, "F32_CAP_ROWS", 3 * fd.F32_ROWS)
    ins, params, spec, gf, ga, live = _f32_inputs(dev, "all", R=6)
    assert int(live.sum()) * spec.K > 5 * fd.bwd_f32_cap(ins[0].shape[0])
    _f, gk = _hold_f32(ins, params, spec, gf, ga)
    again = fd.fused_decode_bwd(*ins, params, spec, gf, ga)
    for a, b in zip(tree_leaves(gk), tree_leaves(again)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [dict(H=128, L1=1, L3=1, K=4),
                                dict(K=16, L1=1, L3=3),
                                dict(L1=4, L3=4, R=6),
                                dict(K=64, R=4)])
def test_f32_decode_other_shapes(dev, kw):
    """Another width, depths from 2 to 8 layers, K from 4 to 64 (a tile of
    one group)."""
    ins, params, spec, gf, ga, live = _f32_inputs(dev, "sparse", **kw)
    (fagg, _a), _g = _hold_f32(ins, params, spec, gf, ga)
    assert not bool(fagg[~live].any())


def test_f32_decode_eval_chunk_size(dev):
    """K3 on 5,898,240 rows (an 800 x 800 frame's eval chunk of 9,216 rays
    x 80 slots x 8 neighbors), ~2% of the groups live: the plain
    version's bar, dead groups exactly 0."""
    from pointnerf_tpu_torch.ops.fused_decode import (DecodeSpec,
                                                      fused_decode,
                                                      fused_decode_plain)
    spec = DecodeSpec(Fi=32, Dd=6, E=7, Ff=3, Fd=5, H=256, K=8, L1=2, L3=2,
                      neg_slope=0.01, bf16=False)
    G = 9216 * 80
    M = G * 8
    g = torch.Generator(device=dev).manual_seed(1)
    live = torch.rand(G, generator=g, device=dev) < 0.02
    feat = torch.randn((M, 32), generator=g, device=dev) * 0.5
    dists = torch.randn((M, 6), generator=g, device=dev) * 0.05
    extras = torch.randn((M, 7), generator=g, device=dev) * 0.5
    w = torch.rand((M, 1), generator=g, device=dev) \
        * live.repeat_interleave(8)[:, None]
    _i, params, _s, _gf, _ga, _l = _f32_inputs(dev, "none", R=1)
    fk, ak = fused_decode(feat, dists, extras, w, params, spec)
    fp, ap = fused_decode_plain(feat, dists, extras, w, params, spec)
    torch.cuda.synchronize()
    for a, b in ((fk, fp), (ak, ap)):
        assert float((a - b).abs().max()) <= 2e-4 * float(b.abs().max())
        assert not bool(a[~live].any())


@pytest.mark.parametrize("kw", [{}, dict(H=128, L1=1, L3=1),
                                dict(Fi=120, H=256, L1=1, L3=1, E=20),
                                dict(H=512)])
def test_f32_smem_formulas_match_the_kernels(dev, kw):
    from pointnerf_tpu_torch.ops.fused_decode import (DecodeSpec,
                                                      bwd_smem_bytes,
                                                      f32_smem_bytes_built,
                                                      smem_bytes)
    d = dict(Fi=32, Dd=6, E=7, Ff=3, Fd=5, H=256, K=8, L1=2, L3=2,
             neg_slope=0.01, bf16=False)
    d.update(kw)
    spec = DecodeSpec(**d)
    want = (smem_bytes(spec), *bwd_smem_bytes(spec))
    if spec.H > 256:
        want = (0, 0, 0)           # the kernels refuse it
    assert f32_smem_bytes_built(spec) == want


@pytest.mark.parametrize("SR", [88, 160])
def test_fused_march_at_the_hybrid_and_fine_shapes(dev, SR):
    """K2 at the hybrid's merged sequence (SR 80 + 8 field samples) and the
    fine pass's (80 + 80), C = 3: within 1e-5 of its plain version, and the
    hybrid's blend weights from K2's opacity (the exclusive cumprod) equal
    to the plain march's."""
    from pointnerf_tpu_torch.models.ray_march import (
        alpha_blend, exclusive_transmission, radiance_render, ray_march)
    from pointnerf_tpu_torch.ops.fused_march import (fused_march,
                                                     fused_march_plain)
    g = torch.Generator().manual_seed(SR)
    R, C = 3600, 3
    dist = torch.rand((R, SR), generator=g) * 0.02
    valid = torch.rand((R, SR), generator=g) > 0.5
    feats = torch.rand((R, SR, C + 1), generator=g) * 30
    bg = torch.ones(C)
    ins = [t.to(dev) for t in (dist, valid, feats, bg)]
    outs = fused_march(*ins)
    for a, b in zip(outs, fused_march_plain(*ins)):
        assert float((a - b).abs().max()) <= 1e-5
    bw = outs[1] * exclusive_transmission(outs[1])
    plain = ray_march(ins[0], ins[1], ins[2], radiance_render, alpha_blend,
                      ins[3])
    assert torch.equal(outs[1], plain[2])
    assert torch.equal(bw, plain[4][..., 0])


# ---- the MVS stack (slice 9): card vs CPU --------------------------------
# MVSNet's convolutions run in f32 (TF32 off) on both sides; the bars are
# those the JAX package held against the reference's torch MVSNet: depth
# max |err| / max |depth|, conf and prob max |err| within 1e-4, the
# train-mode running stats within 1e-5
MVS_TOL = 1e-4
MVS_STATS_TOL = 1e-5


def _seeded_mvs(seed=1, F=8):
    """An MvsPointsInit (3 views) on the CPU with every weight drawn from a
    numpy seed: kernels of spread 1/sqrt(fan_in), BatchNorm scales near 1,
    nonzero biases and running stats (tests/test_torch_mvs.py's fill)."""
    from pointnerf_tpu_torch.mvs.points_init import MvsPointsInit
    model = MvsPointsInit(point_features_dim=F)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(
                model.named_buffers()):
            shape = tuple(t.shape)
            if name.endswith("bn.weight"):
                v = 1 + 0.1 * rng.randn(*shape)
            elif name.endswith("running_mean"):
                v = 0.1 * rng.randn(*shape)
            elif name.endswith("running_var"):
                v = 1 + 0.2 * rng.rand(*shape)
            elif name.endswith("weight"):
                # fan-in: all but the first axis (a transposed
                # convolution's output channels, as in flax's layout)
                v = rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))
            else:
                v = 0.05 * rng.randn(*shape)
            t.copy_(torch.tensor(v.astype(np.float32)))
    return model


def _mvs_case(V=3, H=32, W=64, D=8):
    from pointnerf_tpu_torch.mvs.points_init import view_proj_mats
    rng = np.random.RandomState(0)
    imgs = rng.rand(V, 3, H, W).astype(np.float32)
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    Ks = np.stack([K] * V)
    w2cs = np.stack([np.eye(4, dtype=np.float32)] * V)
    for v in range(V):
        w2cs[v][0, 3] = -0.1 * v
    return (torch.tensor(imgs), torch.tensor(view_proj_mats(Ks, w2cs, 0)),
            torch.linspace(2.0, 6.0, D))


@pytest.mark.parametrize("train", [False, True])
def test_mvsnet_card_matches_cpu(dev, train):
    import copy
    from pointnerf_tpu_torch.mvs.points_init import mvs_apply, mvs_variables
    model = _seeded_mvs()
    gpu = copy.deepcopy(model).to(dev)
    args = _mvs_case()
    outs, stats = [], []
    for m, d in ((model, "cpu"), (gpu, dev)):
        var = mvs_variables(m)
        var["batch_stats"] = {k: v.clone() for k, v in
                              var["batch_stats"].items()}
        outs.append(mvs_apply(m, var, *[a.to(d) for a in args], train))
        stats.append(var["batch_stats"])
    (cd, cc, cf, cp), (gd, gc, gf, gp) = outs
    assert float((gd.cpu() - cd).abs().max() / cd.abs().max()) <= MVS_TOL
    assert float((gc.cpu() - cc).abs().max()) <= MVS_TOL
    assert float((gp.cpu() - cp).abs().max()) <= MVS_TOL
    assert float((gf.cpu() - cf).abs().max() / cf.abs().max()) <= MVS_TOL
    for k, v in stats[0].items():
        assert float((stats[1][k].cpu() - v).abs().max()) <= MVS_STATS_TOL, k


def test_bilinear_sample_card_matches_cpu(dev):
    from pointnerf_tpu_torch.ops.sample2d import bilinear_sample
    g = torch.Generator().manual_seed(0)
    img = torch.randn((5, 9, 11), generator=g)
    x = torch.rand(300, generator=g) * 14 - 2
    y = torch.rand(300, generator=g) * 12 - 2
    ct = torch.randn((5, 300), generator=g)
    res = []
    for d in ("cpu", dev):
        ins = [t.to(d).requires_grad_() for t in (img, x, y)]
        out = bilinear_sample(*ins)
        res.append([out] + list(torch.autograd.grad(out, ins, ct.to(d))))
    for a, b in zip(res[1], res[0]):
        assert float((a.detach().cpu() - b).abs().max()) <= \
            1e-6 * float(b.abs().max())


def test_feedforward_step_launches_the_f32_kernels(dev):
    """One feed-forward step (ff_demo's config on its 32 x 32 sphere
    views) on the card: K3 f32 and K4 f32 launch once each, K2 never, the
    loss is finite and MVSNet's weights move."""
    from pointnerf_tpu_torch.data.synthetic import (ring_cameras,
                                                    view_ray_batch)
    from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
    from pointnerf_tpu_torch.models.renderer import ray_batch_from_numpy
    from pointnerf_tpu_torch.mvs.points_init import (init_mvs_points,
                                                     new_mvs_model)
    from pointnerf_tpu_torch.ops import fused_decode as fd
    from pointnerf_tpu_torch.ops.fused_march import fused_march
    from pointnerf_tpu_torch.train import driver as td
    from pointnerf_tpu_torch.train import feedforward as tff
    cfg = td.ff_demo_config()
    model = new_mvs_model(cfg.agg.point_features_dim, device=dev)
    variables = init_mvs_points(model, torch.Generator().manual_seed(0))
    agg = init_aggregator_params(cfg.agg, torch.Generator().manual_seed(1),
                                 device=dev)
    state = tff.create_ff_state(torch.Generator(device=dev).manual_seed(2),
                                variables, agg, cfg)
    views = ring_cameras(n_views=4, wh=(32, 32), focal=32.0)
    imgs, Ks, w2cs = [], [], []
    for campos, rot, K in views[:3]:
        imgs.append(view_ray_batch(campos, rot, K, (32, 32))[
            "gt_image"].reshape(32, 32, 3))
        Ks.append(K)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3], w2c[:3, 3] = rot.T, -rot.T @ campos
        w2cs.append(w2c)
    rays = ray_batch_from_numpy(view_ray_batch(*views[3], (32, 32),
                                               n_rays=64, seed=0), cfg,
                                device=dev)
    batch = td._mvs_batch(np.stack(imgs), np.stack(Ks), np.stack(w2cs),
                          np.linspace(2.0, 4.5, 16, dtype=np.float32), rays,
                          dev)
    fd.reset_launches()
    fused_march.launches = 0
    step = tff.make_feedforward_step(cfg, model, 128)[0]
    new, items = step(state, batch)
    torch.cuda.synchronize()
    assert fd.fused_decode.launches_by_route == {"tensor_core": 0,
                                                 "cuda_core": 1,
                                                 "general": 0}
    assert fd.fused_decode_bwd.launches_by_route == {"tensor_core": 0,
                                                     "cuda_core": 1,
                                                     "general": 0}
    assert fused_march.launches == 0
    assert bool(torch.isfinite(items["loss_total"]))
    k = "mvsnet.cost_regularization.conv0.conv.weight"
    assert not torch.equal(new.params["mvs"][k], state.params["mvs"][k])


# the general kernels (csrc/fused_decode_any.cu, csrc/fused_decode_bwd_any.cu):
# specs past the tuned kernels' limits, in both roundings, on the tensor
# cores (bf16) or the CUDA cores (f32, and bf16 in the workspace case "wide",
# whose K4 tile does not fit shared memory). In bf16 each
# output and gradient is held on its mean error and on its largest, each
# relative to the plain version's scale, at bars that lie under the
# control (the f32 plain version in place of the bf16 one). Readings on an
# H100 80GB HBM3 at 700 W, of these cases: K4's
# worst mean 5.7e-03 (nine layers; 2.1e-05 at most elsewhere), worst
# largest 7.7e-02 (nine layers; 1.0e-03 elsewhere); K3's largest 6.7e-04
K3_BF16_MAX_TOL = {"fagg": 3e-2, "alpha": 1e-2}
GENERAL_K4_BF16_TOL = 1e-2
GENERAL_K4_BF16_MAX_TOL = 0.15
# At H = 512 the control of the largest error (the f32 plain version in
# place of the bf16 one) reads 0.142, under 0.15 (H100 80GB HBM3, 700 W),
# so that case is held at the tighter 5e-2, which the control fails
GENERAL_K4_BF16_MAX_TOL_AT = {"h512": 5e-2}
GENERAL_CASES = {
    "h48": dict(H=48),                          # not a multiple of 32
    "h320": dict(H=320, L1=1, L3=1),            # past 256 columns
    "k6": dict(K=6),                            # 64 % K != 0
    "deep9": dict(H=64, L1=5, L3=4),            # nine block layers
    "fi100": dict(Fi=100, H=64),                # x1 = 760: past 320 (bf16)
                                                # and f32 shared memory
    "k100": dict(H=40, K=100, L1=1, L3=1, G=30),  # a tile of one group
    "small": dict(Fi=4, Dd=3, E=0, Ff=0, Fd=0, H=20, L1=1, L3=1),
    "h512": dict(H=512),                        # bench widths at H = 512
    "k12": dict(K=12),                          # 5 groups = 60 of 64 rows
    "wide": dict(Fi=400, H=40, L1=1, L3=1, G=40),  # x1 = 2,860: the
                                                # workspace placement
}


def _general_inputs(dev, H=256, K=8, L1=2, L3=2, Fi=32, Dd=6, E=7, Ff=3,
                    Fd=5, G=301, bf16=True, seed=21, dead_from=None):
    """Decode inputs, weights and upstream gradients of a spec past the
    tuned kernels' limits; groups from `dead_from` on get w == 0 and zero
    upstream gradients."""
    from pointnerf_tpu_torch.ops.fused_decode import DecodeSpec, layer_inputs
    spec = DecodeSpec(Fi=Fi, Dd=Dd, E=E, Ff=Ff, Fd=Fd, H=H, K=K, L1=L1,
                      L3=L3, neg_slope=0.01, bf16=bf16)
    M = G * K
    rng = np.random.RandomState(seed)
    ins = [rng.normal(0, s, (M, n)).astype(np.float32)
           for s, n in ((0.5, Fi), (0.05, Dd), (0.5, E))]
    w = (rng.rand(M, 1) * (rng.rand(M, 1) > 0.3)).astype(np.float32)
    gf = rng.normal(0, 1, (G, H)).astype(np.float32)
    ga = rng.normal(0, 1, (G, 1)).astype(np.float32)
    if dead_from is not None:
        w[dead_from * K:] = 0.0
        gf[dead_from:] = 0.0
        ga[dead_from:] = 0.0
    g = torch.Generator().manual_seed(seed)

    def dense(n_in):
        return {"w": (torch.randn((n_in, H), generator=g)
                      * (2.0 / n_in) ** 0.5).to(dev),
                "b": (torch.randn((H,), generator=g) * 0.1).to(dev)}
    dims = layer_inputs(spec)
    params = {"block1": [dense(n) for n in dims[:L1]],
              "block3": [dense(n) for n in dims[L1:]],
              "alpha": [{"w": (torch.randn((H, 1), generator=g)
                               * 0.1).to(dev),
                         "b": torch.zeros((1,)).to(dev)}]}
    t = [torch.from_numpy(a).to(dev) for a in ins + [w]]
    return (t, params, spec, torch.from_numpy(gf).to(dev),
            torch.from_numpy(ga).to(dev))


def _rel_max(a, b):
    s = float(b.abs().max()) if b.numel() else 0.0
    e = float((a - b).abs().max()) if b.numel() else 0.0
    return e / s if s > 0 else e


def _kernel_masks(ins, params, spec, gf, ga):
    """The general K4's result and its leaky-ReLU branches: each layer's
    [M, H] z > 0 as the kernel took it, read off the signs of the layer
    outputs its phase A wrote (`general_bwd_scratch`), False on rows it did
    not visit (no weight, no upstream gradient: zero there either way)."""
    from pointnerf_tpu_torch.ops import fused_decode as fd
    out, rows, acts, _gzs = fd.general_bwd_scratch(*ins, params, spec, gf,
                                                   ga)
    masks = []
    for a in acts[1:]:
        m = torch.zeros((ins[0].shape[0], spec.H), dtype=torch.bool,
                        device=a.device)
        m[rows] = a[:, :spec.H] > 0
        masks.append(m)
    return out, masks


def _hold_general(ins, params, spec, gf, ga, max_tol=GENERAL_K4_BF16_MAX_TOL,
                  masks=None):
    """K3 and K4 on the general route against their plain versions: f32
    within 2e-4 of each output's or gradient's max|plain|, K4's plain
    version fed the kernel's leaky-ReLU branches (`masks`, by default
    `_kernel_masks`': a pre-activation within rounding of 0 may take either
    branch in any f32 summation order, and its row's gradients then move by
    up to 0.99 of one g_h element); bf16 on the mean error (K3_BF16_TOL,
    GENERAL_K4_BF16_TOL) and on the largest (K3_BF16_MAX_TOL, `max_tol`),
    each bar under its control. Returns the kernels' outputs."""
    from pointnerf_tpu_torch.ops import fused_decode as fd
    from pointnerf_tpu_torch.train.optim import tree_leaves
    assert fd.route(spec) == "general"
    assert fd.route(spec, backward=True) == "general"
    n3 = fd.fused_decode.launches_by_route["general"]
    n4 = fd.fused_decode_bwd.launches_by_route["general"]
    fk = fd.fused_decode(*ins, params, spec)
    gk = fd.fused_decode_bwd(*ins, params, spec, gf, ga)
    assert fd.fused_decode.launches_by_route["general"] == n3 + 1
    assert fd.fused_decode_bwd.launches_by_route["general"] == n4 + 1
    fp = fd.fused_decode_plain(*ins, params, spec)
    torch.cuda.synchronize()
    if not spec.bf16:
        for a, b in zip(fk, fp):
            assert _rel_max(a, b) <= 2e-4
        if masks is None:
            again, masks = _kernel_masks(ins, params, spec, gf, ga)
            for a, b in zip(gk[:4], again[:4]):
                assert torch.equal(a, b)
        gp = tree_leaves(fd.fused_decode_bwd_plain(*ins, params, spec, gf,
                                                   ga, masks=masks))
        for a, b in zip(tree_leaves(gk), gp):
            assert _rel_max(a, b) <= 2e-4
        return fk, gk
    gp = tree_leaves(fd.fused_decode_bwd_plain(*ins, params, spec, gf, ga))
    f32 = spec._replace(bf16=False)
    fc = fd.fused_decode_plain(*ins, params, f32)
    gc = tree_leaves(fd.fused_decode_bwd_plain(*ins, params, f32, gf, ga))
    for name, a, b, c in zip(("fagg", "alpha"), fk, fp, fc):
        assert _mean_rel(a, b) <= K3_BF16_TOL < _mean_rel(c, b), name
        assert _rel_max(a, b) <= K3_BF16_MAX_TOL[name], name
    live = [(a, b, c) for a, b, c in zip(tree_leaves(gk), gp, gc)
            if b.numel()]
    assert max(_mean_rel(a, b) for a, b, _c in live) <= GENERAL_K4_BF16_TOL \
        < max(_mean_rel(c, b) for _a, b, c in live)
    assert max(_rel_max(a, b) for a, b, _c in live) \
        <= max_tol < max(_rel_max(c, b) for _a, b, c in live)
    return fk, gk


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", sorted(GENERAL_CASES))
def test_general_decode_matches_plain(dev, case, bf16):
    _hold_general(*_general_inputs(dev, bf16=bf16, **GENERAL_CASES[case]),
                  max_tol=GENERAL_K4_BF16_MAX_TOL_AT.get(
                      case, GENERAL_K4_BF16_MAX_TOL))


@pytest.mark.parametrize("case", ["k6", "small"])
def test_general_decode_dead_tiles_are_zero(dev, case):
    """Groups without weight and upstream gradient give exactly 0 in every
    output row they own."""
    kw = dict(GENERAL_CASES[case])
    G = kw.pop("G", 301)
    K = kw.get("K", 8)
    ins, params, spec, gf, ga = _general_inputs(dev, G=G, dead_from=G // 3,
                                                **kw)
    (fagg, alpha), (g_feat, g_dists, g_extras, g_w, _gp) = _hold_general(
        ins, params, spec, gf, ga)
    g0 = -(-(G // 3) // (64 // K)) * (64 // K)   # the first dead tile
    assert not bool(fagg[G // 3:].any()) and not bool(alpha[G // 3:].any())
    for t in (g_feat, g_dists, g_extras, g_w):
        assert not bool(t[g0 * K:].any())


@pytest.mark.parametrize("bf16", [False, True])
def test_general_decode_bwd_bit_identical(dev, bf16):
    """Every gradient is the same bits in two calls (per-CTA partials
    summed in CTA order, no atomics)."""
    from pointnerf_tpu_torch.ops.fused_decode import fused_decode_bwd
    from pointnerf_tpu_torch.train.optim import tree_leaves
    ins, params, spec, gf, ga = _general_inputs(dev, bf16=bf16,
                                                **GENERAL_CASES["k6"])
    a = tree_leaves(fused_decode_bwd(*ins, params, spec, gf, ga))
    b = tree_leaves(fused_decode_bwd(*ins, params, spec, gf, ga))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bf16", [False, True])
def test_general_decode_bwd_in_batches(dev, bf16, monkeypatch):
    """With the scratch cut to 3 tiles, K4 takes its live rows in many
    batches (phase B adding to its partials, the slice sums carried, the
    scratch reused): held at the bars, the row gradients the same bits as
    one batch's, dW / db within the f32 bar of them, two calls the same
    bits."""
    from pointnerf_tpu_torch.ops import fused_decode as fd
    from pointnerf_tpu_torch.train.optim import tree_leaves
    ins, params, spec, gf, ga = _general_inputs(dev, bf16=bf16,
                                                **GENERAL_CASES["k6"])
    M = ins[0].shape[0]
    one, masks = _kernel_masks(ins, params, spec, gf, ga)
    T = fd.any_plan(spec, M, backward=True).T
    monkeypatch.setattr(fd, "GENERAL_CAP_ROWS", 3 * T)
    assert fd.any_plan(spec, M, backward=True).cap == 3 * T
    live = int(fd.live_groups(ins[3], spec.K, gf, ga).numel()) * spec.K
    assert live > 5 * 3 * T
    _f, gk = _hold_general(ins, params, spec, gf, ga, masks=masks)
    again = fd.fused_decode_bwd(*ins, params, spec, gf, ga)
    for i, (a, b, c) in enumerate(zip(tree_leaves(gk), tree_leaves(one),
                                      tree_leaves(again))):
        assert torch.equal(a, c)
        if i < 4:
            assert torch.equal(a, b)
        else:
            assert _rel_max(a, b) <= 2e-4


def test_general_decode_state_in_shared_and_global_memory(dev):
    """The built kernels plan every case as the Python mirror does
    (`general_plan`), K3 and K4 in both roundings: every case's tile state
    in shared memory, but the workspace case "wide" (its f32 K3 and K4 and
    its bf16 K4), which holds at the bars too."""
    from pointnerf_tpu_torch.ops.fused_decode import (DecodeSpec, any_plan,
                                                      general_plan)
    for case, kw in GENERAL_CASES.items():
        kw = dict(kw)
        G = kw.pop("G", 301)
        d = dict(Fi=32, Dd=6, E=7, Ff=3, Fd=5, H=256, K=8, L1=2, L3=2,
                 neg_slope=0.01)
        d.update(kw)
        for bf16 in (False, True):
            spec = DecodeSpec(bf16=bf16, **d)
            for backward in (False, True):
                got = any_plan(spec, G * spec.K, backward)
                assert got.grid > 0 and (got.cap > 0) == backward
                assert got._replace(grid=0, smem_b=0, dw_blocks=0, cap=0) \
                    == general_plan(spec, backward), (case, bf16, backward)
                in_ws = case == "wide" and (backward or not bf16)
                assert (got.ws > 0) == in_ws, (case, bf16, backward)
    for bf16 in (False, True):
        _hold_general(*_general_inputs(dev, bf16=bf16,
                                       **GENERAL_CASES["wide"]))


@pytest.mark.parametrize("case", ["h512", "k6"])
def test_general_decode_dense_f32(dev, case):
    """A dense f32 step's layout: [R, SR, K] rows with ~1% of the groups
    live, scattered over every ray, random features on every row. K3 and K4
    hold at the f32 bar, every output of a dead group is exactly 0, and the
    list the kernels decode (K3's rule and K4's) equals its plain
    version."""
    from pointnerf_tpu_torch.ops.fused_decode import (live_groups,
                                                      live_groups_plain)
    kw = dict(GENERAL_CASES[case])
    ins, params, spec, gf, ga, live = _f32_inputs(
        dev, "none", R=32, SR=80, **{k: kw.get(k, v) for k, v in
                                    (("K", 8), ("H", 256))})
    rng = np.random.RandomState(5)
    G, K = live.shape[0], spec.K
    pick = torch.from_numpy(rng.rand(G) < 0.01).to(dev)
    w = torch.from_numpy(rng.rand(G * K, 1).astype(np.float32)).to(dev) \
        * pick.repeat_interleave(K)[:, None]
    gf = gf + torch.randn(gf.shape, generator=torch.Generator().manual_seed(
        5)).to(dev) * pick[:, None]
    ga = ga + pick[:, None].float()
    ins = ins[:3] + [w]
    (fagg, alpha), (g_feat, _gd, g_extras, g_w, _gp) = _hold_general(
        ins, params, spec, gf, ga)
    assert not bool(fagg[~pick].any()) and not bool(alpha[~pick].any())
    for t in (g_feat, g_extras, g_w):
        assert not bool(t.view(G, K, -1)[~pick].any())
    for args in ((), (gf, ga)):
        assert torch.equal(live_groups(w, K, *args).cpu(),
                           live_groups_plain(w.cpu(), K,
                                             *[a.cpu() for a in args]))
    assert int(live_groups(w, K).numel()) == int(pick.sum())


def test_general_autograd_launches_both_kernels(dev):
    """The autograd Function at a general spec launches general K3 forward
    and general K4 backward, and its gradients are K4's."""
    from pointnerf_tpu_torch.ops import fused_decode as fd
    from pointnerf_tpu_torch.train.optim import tree_leaves, tree_map
    ins, params, spec, gf, ga = _general_inputs(dev, **GENERAL_CASES["h48"])
    gk = tree_leaves(fd.fused_decode_bwd(*ins, params, spec, gf, ga))
    xs = [t.clone().requires_grad_() for t in ins]
    p = tree_map(lambda t: t.clone().requires_grad_(), params)
    n3 = fd.fused_decode.launches_by_route["general"]
    n4 = fd.fused_decode_bwd.launches_by_route["general"]
    f, a = fd.fused_decode(*xs, p, spec)
    got = torch.autograd.grad((f * gf).sum() + (a * ga).sum(),
                              xs + tree_leaves(p))
    assert fd.fused_decode.launches_by_route["general"] == n3 + 1
    assert fd.fused_decode_bwd.launches_by_route["general"] == n4 + 1
    for x, y in zip(got, gk):
        assert torch.equal(x, y)
