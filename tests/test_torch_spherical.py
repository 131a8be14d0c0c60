"""The port's real spherical harmonics (pointnerf_tpu_torch/ops/spherical.py)
against the JAX package's (pointnerf_tpu/ops/spherical.py): the closed forms
of degrees 1-4 and the Legendre recurrence above, on the same unit
directions, within 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.ops.spherical import sh_basis as j_sh_basis
from pointnerf_tpu.ops.spherical import sh_eval as j_sh_eval
from pointnerf_tpu_torch.ops.spherical import sh_basis, sh_eval

TOL = 1e-6


def _dirs(n=257, seed=0):
    rng = np.random.RandomState(seed)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d[:3] = np.eye(3, dtype=np.float32)               # the poles and axes
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5, 6])
def test_sh_basis_matches_jax(degree):
    d = _dirs(seed=degree)
    bj = np.asarray(j_sh_basis(degree, jnp.asarray(d)))
    bt = sh_basis(degree, torch.from_numpy(d)).numpy()
    assert bt.shape == bj.shape == (len(d), degree ** 2)
    np.testing.assert_allclose(bt, bj, rtol=0, atol=TOL)


def test_sh_basis_recurrence_agrees_with_the_closed_forms():
    """The recurrence's first 16 functions are the closed forms of degree
    4, in the same order and convention."""
    from pointnerf_tpu_torch.ops.spherical import _sh_basis_recurrence
    d = torch.from_numpy(_dirs(seed=9))
    np.testing.assert_allclose(_sh_basis_recurrence(4, d).numpy(),
                               sh_basis(4, d).numpy(), rtol=0, atol=TOL)


def test_sh_eval_matches_jax_and_refuses_degree_0():
    d = _dirs(n=64, seed=3)
    c = np.random.RandomState(4).normal(0, 1, (64, 9, 5)).astype(np.float32)
    ej = np.asarray(j_sh_eval(jnp.asarray(c), jnp.asarray(d), 3))
    et = sh_eval(torch.from_numpy(c), torch.from_numpy(d), 3).numpy()
    np.testing.assert_allclose(et, ej, rtol=0, atol=10 * TOL)
    with pytest.raises(ValueError, match="unsupported"):
        sh_basis(0, torch.from_numpy(d))
