"""The port's 2D neural-render heads (pointnerf_tpu_torch/models/
neural_render.py) against the flax modules of pointnerf_tpu/models/
neural_render.py, with a seeded fill of flax's parameter tree (`flax_fill`,
at the scales of flax's initializers) converted by
`convert.neural_render_from_flax`, on seeded numpy inputs (NHWC for JAX,
NCHW for the port). Bars: outputs within 2e-5 of max|JAX|; the gradients
of sum(out * ct) with respect to the inputs and every weight within 2e-4
of each one's max|JAX| (the repo's gradient bar)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.models import neural_render as jn
from pointnerf_tpu_torch.convert import neural_render_from_flax
from pointnerf_tpu_torch.models import neural_render as tn

OUT_TOL = 2e-5
GRAD_TOL = 2e-4


def flax_fill(jmod, seed, *args):
    """A seeded numpy fill of `jmod`'s flax parameter tree, its shapes from
    jax.eval_shape of init (compiling flax's init costs seconds a module):
    conv and Dense kernels N(0, 1 / fan_in), Conv2DMod's weight N(0, 2 /
    ((1 + 0.2^2) fan_in)) and EqualLinear's N(0, 1), as flax's initializers
    draw them; biases 0.1 N(0, 1) and GroupNorm scales 1 + 0.1 N(0, 1),
    where flax starts them at 0 and 1."""
    rng = np.random.RandomState(seed)
    tree = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                          *[jnp.asarray(a) for a in args])["params"]

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        z = rng.randn(*shape).astype(np.float32)
        fan_in = math.prod(shape[:-1])
        if name == "kernel":
            return z / np.float32(math.sqrt(fan_in))
        if name == "weight":
            return (z * np.float32(math.sqrt(2.0 / (1.04 * fan_in)))
                    if len(shape) == 4 else z)
        return z * np.float32(0.1) + np.float32(name == "scale")
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _nchw(a):
    return np.ascontiguousarray(a.transpose(0, 3, 1, 2))


def _close(a, b, tol, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-12)
    err = float(np.abs(a - b).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def _hold(jmod, tmod, args, image_args, out_is_image=True, seed=0,
          zero_grads=()):
    """Forward and gradients of `jmod` (flax) and `tmod` (port) on `args`
    (numpy, JAX layout); `image_args` marks the NHWC ones. The weights
    (`flax_fill`) go to the port through the converter. A leaf in `zero_grads`
    has a gradient of exactly zero in exact arithmetic (a bias before a
    per-channel normalization): both sides' rounding noise must lie within
    the bar of the same layer's weight gradient."""
    jargs = [jnp.asarray(a) for a in args]
    params = flax_fill(jmod, seed, *args)
    shape = jax.eval_shape(jmod.apply, {"params": params}, *jargs).shape
    ct = np.random.RandomState(seed + 100).randn(*shape).astype(np.float32)

    def f(p, *a):
        out = jmod.apply({"params": p}, *a)
        return jnp.sum(out * ct), out
    gj, out_j = jax.jit(jax.grad(f, argnums=tuple(range(len(args) + 1)),
                                 has_aux=True))(params, *jargs)
    tp = neural_render_from_flax(tmod, jax.tree.map(np.asarray, params),
                                 device="cpu")
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    targs = [torch.tensor(_nchw(a) if img else a, requires_grad=True)
             for a, img in zip(args, image_args)]
    out_t = tn.apply_head(tmod, tp, *targs)
    ct_t = torch.tensor(_nchw(ct) if out_is_image else ct)
    (out_t * ct_t).sum().backward()
    o = out_t.detach().numpy()
    _close(o.transpose(0, 2, 3, 1) if out_is_image else o, out_j, OUT_TOL,
           "output")
    gp_j = neural_render_from_flax(tmod, jax.tree.map(np.asarray, gj[0]),
                                   device="cpu")
    assert set(gp_j) == set(tp)
    for k in tp:
        if k in zero_grads:
            w = k.replace(".bias", ".weight")
            bar = GRAD_TOL * float(gp_j[w].abs().max())
            assert float(tp[k].grad.abs().max()) <= bar, k
            assert float(gp_j[k].abs().max()) <= bar, k
            continue
        _close(tp[k].grad.numpy(), gp_j[k].numpy(), GRAD_TOL, f"d{k}")
    for i, (t, img) in enumerate(zip(targs, image_args)):
        g = t.grad.numpy()
        _close(g.transpose(0, 2, 3, 1) if img else g, gj[i + 1], GRAD_TOL,
               f"d input {i}")
    return out_j


@pytest.mark.parametrize("n_feat,input_dim,skip,norm",
                         [(32, 16, True, False), (16, 16, False, True),
                          (32, 16, True, True)])
def test_neural_renderer_matches_flax(n_feat, input_dim, skip, norm):
    """Two blocks (img_size 64), with and without the RGB skip and the
    GroupNorm (flax's epsilon 1e-6), with and without the input 1x1."""
    kw = dict(n_feat=n_feat, input_dim=input_dim, img_size=64, min_feat=8,
              use_rgb_skip=skip, use_norm=norm)
    x = np.random.RandomState(1).rand(2, 12, 12, input_dim).astype(
        np.float32)
    tmod = tn.NeuralRenderer(**kw)
    # the block convolutions' biases feed a one-channel-group norm
    zero = {f"{hid}.bias" for hid, gn, _rgb in tmod.blocks if gn}
    out = _hold(jn.NeuralRenderer(**kw), tmod, [x], [True], zero_grads=zero)
    assert out.shape == (2, 12, 12, 3)


@pytest.mark.parametrize("image_size,h", [(128, 12), (256, 8)])
def test_generator_matches_flax(image_size, h):
    """One layer (the patch size kept) and two (the upsample path: the
    feature image doubled, the first block's RGB upsampled and blurred)."""
    n_layers = int(np.log2(image_size) - 6)
    kw = dict(image_size=image_size, latent_dim=8, network_capacity=4,
              init_channels=16)
    rng = np.random.RandomState(2)
    styles = rng.randn(2, n_layers, 8).astype(np.float32)
    initial = rng.rand(2, h, h, 16).astype(np.float32)
    out = _hold(jn.Generator(**kw), tn.Generator(**kw), [styles, initial],
                [False, True])
    assert out.shape == (2, h * 2 ** (n_layers - 1), h * 2 ** (n_layers - 1),
                         3)


def test_style_vectorizer_matches_flax():
    z = np.random.RandomState(3).randn(4, 8).astype(np.float32)
    _hold(jn.StyleVectorizer(emb=8, depth=3), tn.StyleVectorizer(8, 3),
          [z], [False], out_is_image=False)


@pytest.mark.parametrize("size", [16, 12])
def test_discriminator_matches_flax(size):
    """The stride-2 SAME convolutions: flax pads (0, 1) on an even input
    (16 -> 8 -> 4; 12 -> 6, whose next block keeps it)."""
    img = np.random.RandomState(4).rand(2, size, size, 3).astype(np.float32)
    out = _hold(jn.Discriminator(image_size=size, network_capacity=2),
                tn.Discriminator(size, network_capacity=2), [img], [True],
                out_is_image=False)
    assert out.shape == (2,)


@pytest.mark.parametrize("method,blur", [("bilinear", True),
                                         ("bilinear", False), ("nn", True)])
def test_upsample2x_matches_jax(method, blur):
    """jax.image.resize's 2x bilinear (half-pixel centres, the edge pixels
    clamped) and nearest, at the borders too."""
    x = np.random.RandomState(5).randn(2, 5, 7, 3).astype(np.float32)
    j = np.asarray(jn.upsample2x(jnp.asarray(x), method, blur=blur))
    t = tn.upsample2x(torch.tensor(_nchw(x)), method, blur=blur).numpy()
    _close(t.transpose(0, 2, 3, 1), j, OUT_TOL, f"upsample2x {method}")
    if method == "nn":
        np.testing.assert_array_equal(t.transpose(0, 2, 3, 1), j)


def test_blur_matches_jax():
    x = np.random.RandomState(6).randn(1, 6, 9, 4).astype(np.float32)
    j = np.asarray(jn._blur(jnp.asarray(x)))
    t = tn._blur(torch.tensor(_nchw(x))).numpy()
    _close(t.transpose(0, 2, 3, 1), j, OUT_TOL, "blur")


def test_converter_rejects_a_tree_of_another_module():
    p = flax_fill(jn.StyleVectorizer(emb=8, depth=2), 0, np.zeros((1, 8)))
    with pytest.raises(ValueError, match="does not fit"):
        neural_render_from_flax(tn.StyleVectorizer(8, 3),
                                jax.tree.map(np.asarray, p), device="cpu")


def test_init_draws_from_the_generator():
    """init_neural_render: the same seed gives the same weights, another
    seed others; EqualLinear unit normal, biases zero."""
    mods = [tn.Generator(128, 8, network_capacity=4, init_channels=16)
            for _ in range(3)]
    a, b, c = (tn.init_neural_render(m, torch.Generator().manual_seed(s))
               for m, s in zip(mods, (0, 0, 1)))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["Conv_0.weight"], c["Conv_0.weight"])
    assert all(float(a[k].abs().max()) == 0 for k in a if
               k.endswith("bias"))
    vec = tn.StyleVectorizer(64, 1)
    w = tn.init_neural_render(vec, torch.Generator().manual_seed(0))[
        "EqualLinear_0.weight"]
    assert abs(float(w.std()) - 1.0) < 0.05
