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


def test_fused_march_kernel_matches_plain(dev):
    from pointnerf_tpu_torch.ops.fused_march import (fused_march,
                                                     fused_march_plain)
    g = torch.Generator().manual_seed(1)
    R, SR, C = 333, 80, 3
    dist = (torch.rand((R, SR), generator=g) * 0.1).to(dev)
    valid = (torch.rand((R, SR), generator=g) > 0.3).to(dev)
    feats = torch.rand((R, SR, C + 1), generator=g).to(dev)
    bg = torch.tensor([1.0, 0.5, 0.25], device=dev)
    for a, b in zip(fused_march(dist, valid, feats, bg),
                    fused_march_plain(dist, valid, feats, bg)):
        assert float((a - b).abs().max()) <= 1e-5


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
