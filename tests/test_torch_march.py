"""Port compositor (K2's plain version in pointnerf_tpu_torch/ops/
fused_march.py, and models/ray_march.ray_march) against the JAX Pallas
march (interpret mode via the monkeypatch of tests/test_pallas.py) and the
JAX ray_march, at the march parity bar of 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.models.ray_march import alpha_blend as j_alpha_blend
from pointnerf_tpu.models.ray_march import radiance_render as j_radiance
from pointnerf_tpu.models.ray_march import ray_march as j_ray_march
from pointnerf_tpu_torch.models import ray_march as tm
from pointnerf_tpu_torch.ops.fused_march import fused_march, fused_march_plain

TOL = 1e-5


# fixture copied from tests/test_pallas.py
def _inputs(R=64, SR=16, C=3, seed=0):
    rng = np.random.RandomState(seed)
    dist = rng.rand(R, SR).astype(np.float32) * 0.1
    valid = (rng.rand(R, SR) > 0.3).astype(np.float32)
    feats = rng.rand(R, SR, 1 + C).astype(np.float32)
    bg = np.array([1.0, 0.5, 0.25], np.float32)[:C]
    if C > 3:
        bg = rng.rand(C).astype(np.float32)
    return dist, valid, feats, bg


def _torch(dist, valid, feats, bg):
    return (torch.from_numpy(dist), torch.from_numpy(valid > 0.5),
            torch.from_numpy(feats), torch.from_numpy(bg))


@pytest.fixture
def interpret_pallas(monkeypatch):
    import jax.experimental.pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))


@pytest.mark.parametrize("R,SR,C,seed", [(64, 16, 3, 0), (37, 80, 3, 1),
                                         (5, 7, 4, 2), (19, 80, 16, 3),
                                         (9, 33, 128, 4)])
def test_fused_march_matches_pallas_kernel(interpret_pallas, R, SR, C, seed):
    from pointnerf_tpu.ops import pallas_march as pm
    ins = _inputs(R, SR, C, seed)
    outs_j = pm._pallas_march_fwd_impl(*[jnp.asarray(a) for a in ins])
    outs_t = fused_march(*_torch(*ins))
    for a, b in zip(outs_t, outs_j):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=1e-6)


def test_fused_march_underflow_matches_pallas_kernel(interpret_pallas):
    """Rays whose transmittance underflows to 0 (sigma * dist >= 100 on
    every valid sample) and rays with no valid sample, against the Pallas
    kernel."""
    from pointnerf_tpu.ops import pallas_march as pm
    dist, valid, feats, bg = _inputs(R=24, SR=80, C=3, seed=5)
    feats[:8, :, 0] = 2000.0
    dist[:8] += 0.05
    valid[:8] = 1.0
    valid[8:12] = 0.0
    outs_j = pm._pallas_march_fwd_impl(
        *[jnp.asarray(a) for a in (dist, valid, feats, bg)])
    outs_t = fused_march(*_torch(dist, valid, feats, bg))
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=1e-6)
    bgtr = outs_t[2].numpy()
    assert (bgtr[:8] == 0).all() and (bgtr[8:12] == 1).all()


@pytest.mark.parametrize("SR,C,rays", [(80, 3, 8), (129, 8, 8),
                                       (700, 8, 8), (1000, 8, 4),
                                       (2000, 8, 0)])
def test_fused_march_rays_per_block(SR, C, rays):
    """The tiled kernel's tile of rays: 8 where the shared memory holds
    it, then 4; 0 where no tile fits (the march takes the wide kernel)."""
    from pointnerf_tpu_torch.ops.fused_march import (SMEM_BYTES,
                                                     TILE_RAYS,
                                                     rays_per_block, route,
                                                     smem_bytes)
    assert rays_per_block(SR, C) == rays
    assert route(SR, C) == ("tiled" if rays else "wide")
    if rays:
        assert smem_bytes(rays, SR, C) <= SMEM_BYTES
    if rays != TILE_RAYS[0]:
        assert smem_bytes(2 * max(rays, 2), SR, C) > SMEM_BYTES


def test_fused_march_matches_ray_march():
    dist, valid, feats, bg = _inputs(seed=3)
    color_t, op_t, bgtr_t = fused_march_plain(*_torch(dist, valid, feats, bg))
    (c_j, _pc, op_j, _acc, bw_j, bgtr_j, _) = j_ray_march(
        jnp.asarray(dist), jnp.asarray(valid > 0.5), jnp.asarray(feats),
        j_radiance, j_alpha_blend, jnp.asarray(bg))
    (c_t, _pc, op_t2, acc_t, bw_t, bgtr_t2, bgbw_t) = tm.ray_march(
        *_torch(dist, valid, feats, bg)[:3], tm.radiance_render,
        tm.alpha_blend, torch.from_numpy(bg))
    for a, b in ((color_t, c_j), (op_t, op_j), (bgtr_t, bgtr_j),
                 (c_t, c_j), (op_t2, op_j), (bw_t, bw_j), (bgtr_t2, bgtr_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=1e-6)
    # the depth path's blend weights recomputed from the kernel's opacity
    bw_re = op_t * tm.exclusive_transmission(op_t)
    np.testing.assert_allclose(bw_re.numpy(), np.asarray(bw_j)[..., 0],
                               rtol=TOL, atol=1e-6)


@pytest.mark.parametrize("name", ["gamma", "off", "normalize"])
def test_tonemaps_match(name):
    from pointnerf_tpu.models.ray_march import TONEMAP_FUNCS as J
    x = np.random.RandomState(4).rand(20, 3).astype(np.float32)
    np.testing.assert_allclose(tm.TONEMAP_FUNCS[name](torch.from_numpy(x))
                               .numpy(), np.asarray(J[name](jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_fused_march_checks_inputs():
    dist, valid, feats, bg = _torch(*_inputs(R=4, SR=3))
    with pytest.raises(ValueError, match="valid"):
        fused_march(dist, valid.float(), feats, bg)
    with pytest.raises(ValueError, match="feats"):
        fused_march(dist, valid, feats[:2].contiguous(), bg)


@pytest.mark.parametrize("seed", [0, 1])
def test_alpha_ray_march_matches_jax(seed):
    from pointnerf_tpu.models.ray_march import alpha_ray_march as j_arm
    dist, valid, feats, _bg = _inputs(R=37, SR=24, seed=seed)
    ref = j_arm(jnp.asarray(dist), jnp.asarray(valid > 0.5),
                jnp.asarray(feats), j_alpha_blend)
    got = tm.alpha_ray_march(*_torch(dist, valid, feats, _bg)[:3],
                             tm.alpha_blend)
    assert len(got) == len(ref) == 5
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    from pointnerf_tpu_torch.models import alpha_ray_march
    assert alpha_ray_march is tm.alpha_ray_march
