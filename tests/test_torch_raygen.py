"""The port's five ray generators (pointnerf_tpu_torch/ops/query.py
RAY_GENERATORS) against the JAX package's, compiled, with and without
jitter (the same draw: JAX's `jax.random.uniform` on its key, passed in as
`u`).

The depths decide which voxel a sample lands in, so they are held bit for
bit where the compiled JAX generator has one formulation. For
nerf_near_far_linear XLA contracts a different product of
near * (1 - t) + far * t into its multiply-add depending on the fusion
around it; the port follows the one of the compiled query (where the
depths pick the shading slots), so the un-jittered standalone generator's
bins may sit 1 ulp away, and the query's slot masks and positions are held
bit for bit instead (tests/test_torch_query_branches.py). Segment lengths
agree to 1e-6 relative, positions to 2 ulp (ROADMAP Queue 3, "Ray sample
positions")."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.ops import query as jq
from pointnerf_tpu_torch.ops import query as tq

CASES = ((64, 32, 2.0, 4.5), (400, 16, 2.0, 6.0), (17, 8, 0.5, 3.0),
         (80, 8, 1.5322499960660934, 3.2677500039339065))
GEN_KWARGS = {"near_middle_far": {"middle": 2.8, "middle_split": 0.6}}


def _u_cols(name, D):
    """Columns of the uniform draw each generator takes."""
    if name == "near_far_disparity_linear":
        return D + 1
    if name == "near_middle_far":
        s = GEN_KWARGS[name]["middle_split"]
        return int(D * s) + 1 + int(D * (1.0 - s)) + 2 - 1
    return D


@pytest.mark.parametrize("jitter", [0.0, 0.3])
@pytest.mark.parametrize("name", sorted(jq.RAY_GENERATORS))
def test_ray_generator_matches_jax(name, jitter):
    assert sorted(tq.RAY_GENERATORS) == sorted(jq.RAY_GENERATORS)
    rng = np.random.RandomState(11)
    cp = np.array([0.3, 0.8, -3.0], np.float32)
    kw = GEN_KWARGS.get(name, {})
    for D, R, near, far in CASES:
        rd = rng.randn(R, 3).astype(np.float32)
        key = jax.random.PRNGKey(D)
        pos_j, seg_j, mid_j = (np.asarray(x) for x in jax.jit(
            lambda c, r, k: jq.RAY_GENERATORS[name](
                c, r, D, near, far, jitter=jitter, key=k, **kw))(cp, rd, key))
        u = None
        if jitter:
            u = torch.from_numpy(np.array(jax.random.uniform(
                key, (R, _u_cols(name, D)), dtype=jnp.float32)))
        pos_t, seg_t, mid_t = (x.numpy() for x in tq.RAY_GENERATORS[name](
            torch.from_numpy(cp), torch.from_numpy(rd), D, near, far,
            jitter=jitter, u=u, **kw))
        mid_j = np.broadcast_to(mid_j, mid_t.shape)
        seg_j = np.broadcast_to(seg_j, seg_t.shape)
        if name == "nerf_near_far_linear" and not jitter:
            # bins within 1 ulp, so their differences within 2 ulp of far
            # (times |raydir|, and the product's own rounding)
            assert np.all(np.abs(mid_t - mid_j) <= np.spacing(mid_j))
            norm = np.linalg.norm(rd, axis=-1, keepdims=True)
            bar = (2 * np.spacing(np.float32(far)) * norm
                   + np.spacing(np.abs(seg_j)))
            assert np.all((np.abs(seg_t - seg_j) <= bar)[:, :-1])
        else:
            np.testing.assert_array_equal(mid_t, mid_j)
            np.testing.assert_allclose(seg_t, seg_j, rtol=1e-6, atol=0)
        assert np.all(np.abs(pos_t - pos_j)
                      <= 2 * np.spacing(np.abs(pos_j).max()))


@pytest.mark.parametrize("name", sorted(jq.RAY_GENERATORS))
def test_ray_generator_draws_from_the_generator(name):
    """With a torch.Generator and no `u`, the jitter is drawn on the rays'
    device in the shape the generator takes: two draws differ, the same seed
    repeats, and no jitter leaves the samples on their bins."""
    cp = torch.tensor([0.0, 0.0, -3.0])
    rd = torch.nn.functional.normalize(torch.randn(6, 3), dim=-1)
    kw = GEN_KWARGS.get(name, {})
    f = tq.RAY_GENERATORS[name]

    def run(gen, jitter=0.3):
        return f(cp, rd, 40, 2.0, 4.5, jitter=jitter, generator=gen, **kw)[2]
    a = run(torch.Generator().manual_seed(0))
    b = run(torch.Generator().manual_seed(0))
    c = run(torch.Generator().manual_seed(1))
    plain = run(None, jitter=0.0)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, plain.expand_as(a))
    assert torch.equal(run(None), plain)
