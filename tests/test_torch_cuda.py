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
    torch.cuda.synchronize()
    # chip_smoke.py's bars, relative to the output's scale; in bf16 both
    # versions round at the same places, so they stay far closer than the
    # f32 plain version does to the bf16 one
    scale = max(float(fp.abs().max()), float(ap.abs().max()))
    tol = (1e-5 if bf16 else 2e-4) * scale
    assert float((fk - fp).abs().max()) <= tol
    assert float((ak - ap).abs().max()) <= tol
