"""The port's feature-render training with the 2D heads
(pointnerf_tpu_torch/train/neural2d.py) against the JAX package's
(pointnerf_tpu/train/neural2d.py): the same scene, weights (the heads'
a seeded fill of flax's trees, `flax_fill`) and states
(`convert.neural2d_state_from_jax` / `gan_state_from_jax`), the same rays,
and JAX's draws injected — the render jitter of each render and the
DiffAugment draws of the GAN step.

Config: tiny_test_config() with C = 16 feature channels (above the tiled
K2's 8), a 16 x 16 patch. Bars: the loss, every group's gradients (held
through the first step's Adam moments, mu = (1 - b1) g and nu = (1 - b2)
g^2 from a fresh state), the moments and the parameters within 2e-4 of
each leaf's max|JAX| (the repo's gradient bar), the EMA within 2e-4; frame
0's style code bit-equal while frame 1 trains; a 10-step CNN loss curve
within 1e-3."""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.camera import get_dtu_raydir
from pointnerf_tpu.config import tiny_test_config
from pointnerf_tpu.models import neural_render as jn
from pointnerf_tpu.models.aggregator import init_aggregator_params
from pointnerf_tpu.models.points import make_point_cloud
from pointnerf_tpu.models.renderer import RayBatch
from pointnerf_tpu.train import neural2d as jt
from pointnerf_tpu.train.step import refresh_grid
from pointnerf_tpu_torch import config as tc
from pointnerf_tpu_torch.convert import (gan_state_from_jax,
                                         neural2d_state_from_jax,
                                         point_cloud_from_numpy)
from pointnerf_tpu_torch.models import neural_render as tn
from pointnerf_tpu_torch.models import renderer as tr
from pointnerf_tpu_torch.train import neural2d as tt
from pointnerf_tpu_torch.train import step as ts
from test_render import synthetic_scene
from test_torch_neural_render import flax_fill

PATCH = 16
C_FEAT = 16
TOL = 2e-4
CURVE_TOL = 1e-3


def _feat_cfg():
    cfg = tiny_test_config()
    return cfg.replace(agg=dataclasses.replace(
        cfg.agg, shading_color_channel_num=C_FEAT))


@pytest.fixture(scope="module")
def scene():
    return _scene()


def _scene():
    """The JAX test's scene (tests/test_neural2d.py) on both sides."""
    cfg = _feat_cfg()
    xyz, campos, camrot = synthetic_scene()
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    pc, st = make_point_cloud(xyz, k1, cfg.points, cfg.agg.point_features_dim,
                              capacity=512)
    params = init_aggregator_params(k2, cfg.agg)
    grid = refresh_grid(pc, st, cfg)
    intr = np.array([[80.0, 0, 32.0], [0, 80.0, 32.0], [0, 0, 1]], np.float32)
    x0, y0 = np.random.RandomState(0).randint(0, 64 - PATCH, 2)
    gx, gy = np.meshgrid(np.arange(x0, x0 + PATCH), np.arange(y0, y0 + PATCH))
    pix = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    raydir = get_dtu_raydir(pix, intr, camrot, True).astype(np.float32)
    gt = np.tile(np.array([0.6, 0.3, 0.1], np.float32), (PATCH, PATCH, 1))
    jb = RayBatch(campos=jnp.asarray(campos), camrotc2w=jnp.asarray(camrot),
                  raydir=jnp.asarray(raydir),
                  pixel_idx=jnp.asarray(pix, jnp.int32),
                  near=jnp.asarray(2.0), far=jnp.asarray(4.5), gt_image=None)
    tcfg = tc.PointNeRFConfig.from_json(cfg.to_json())
    tpc, tst = point_cloud_from_numpy(*[np.asarray(a) for a in pc],
                                      num_active=int(st.num_active),
                                      device="cpu")
    tgrid, _ = ts.refresh_grid(tpc, tst, tcfg)
    tb = tr.RayBatch(campos=torch.tensor(campos),
                     camrotc2w=torch.tensor(camrot),
                     raydir=torch.tensor(raydir),
                     pixel_idx=torch.tensor(pix, dtype=torch.int32),
                     near=torch.tensor(2.0), far=torch.tensor(4.5),
                     gt_image=None)
    return dict(cfg=cfg, pc=pc, st=st, params=params, grid=grid, jb=jb,
                gt=jnp.asarray(gt), tcfg=tcfg, tst=tst, tgrid=tgrid, tb=tb,
                tgt=torch.tensor(gt))


def _u(key, cfg):
    """The coarse jitter JAX's render_rays draws from `key`."""
    k_coarse, _ = jax.random.split(key)
    return torch.tensor(np.asarray(jax.random.uniform(
        k_coarse, (PATCH * PATCH, cfg.query.z_depth_dim), dtype=jnp.float32)))


def _aug_draws(key, prob):
    """jt.diff_augment's draws at `key`, as the port's draws dict."""
    k_on, k_flip, k_tx, k_ty, k_cx, k_cy = jax.random.split(key, 6)
    s, ch = max(PATCH // 8, 1), max(PATCH // 2, 1)
    return {"on": int(jax.random.bernoulli(k_on, prob)),
            "flip": int(jax.random.bernoulli(k_flip)),
            "tx": int(jax.random.randint(k_tx, (), 0, 2 * s + 1)),
            "ty": int(jax.random.randint(k_ty, (), 0, 2 * s + 1)),
            "cx": int(jax.random.randint(k_cx, (), 0, PATCH - ch + 1)),
            "cy": int(jax.random.randint(k_cy, (), 0, PATCH - ch + 1))}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _own(sc):
    """Copies of the scene's aggregator params and cloud for a JAX state:
    its step donates them."""
    return jax.tree.map(jnp.copy, (sc["params"], sc["pc"]))


def _close(a, b, tol, what):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-12)
    err = float(np.abs(a - b).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def _close_params(t_params, j_params, heads, what, tol=TOL):
    """Every leaf of a port parameter tree against JAX's (converted to the
    port's layout with the same converter)."""
    ref = tt_groups(j_params, heads)
    for g in ref:
        tl = _leaves(t_params[g])
        jl = _leaves(ref[g])
        assert len(tl) == len(jl), (what, g)
        for i, (a, b) in enumerate(zip(tl, jl)):
            _close(a, b, tol, f"{what} {g} leaf {i}")


def tt_groups(j_params, heads):
    from pointnerf_tpu_torch.convert import _neural2d_groups
    return _neural2d_groups(_np(j_params), heads, torch.device("cpu"))


def _leaves(tree):
    from pointnerf_tpu_torch.train.optim import tree_leaves
    return tree_leaves(tree)


def _moments(opt, group):
    """(mu, nu) of one group of a JAX multi_transform state."""
    adam = opt.inner_states[group].inner_state[0]
    return {group: adam.mu[group]}, {group: adam.nu[group]}


def _hold_g_side(tstate_params, topt, jparams, jopt, heads, what):
    """Parameters and each group's moments (the first step's: the
    gradients) against JAX's."""
    _close_params(tstate_params, jparams, heads, f"{what} params")
    for g in jparams:
        mu, nu = _moments(jopt, g)
        _close_params({g: topt[g].mu}, mu, heads, f"{what} mu")
        _close_params({g: topt[g].nu}, nu, heads, f"{what} nu")
        assert int(topt[g].count) == int(jopt.inner_states[g]
                                         .inner_state[0].count)


def _cnn_head():
    kw = dict(n_feat=16, input_dim=C_FEAT, img_size=32, min_feat=8)
    return jn.NeuralRenderer(**kw), tn.NeuralRenderer(**kw)


def _stylegan():
    gkw = dict(image_size=128, latent_dim=8, network_capacity=4,
               init_channels=C_FEAT)
    return (jn.Generator(**gkw), jn.StyleVectorizer(emb=8, depth=2),
            tn.Generator(**gkw), tn.StyleVectorizer(8, 2))


def _stylegan_params(jgen, jvec):
    """The generator's and the style vectorizer's flax trees (seeded fills,
    as the head tests make them)."""
    return (flax_fill(jgen, 1, np.zeros((1, 1, 8)),
                      np.zeros((1, PATCH, PATCH, C_FEAT))),
            flax_fill(jvec, 2, np.zeros((1, 8))))


def _cnn_states(sc):
    jhead, thead = _cnn_head()
    hp = flax_fill(jhead, 1, np.zeros((1, PATCH, PATCH, C_FEAT)))
    jstate = jt.create_neural2d_state(jax.random.PRNGKey(2), *_own(sc), hp,
                                      sc["cfg"])
    tstate = neural2d_state_from_jax(_np(jstate), torch.Generator(),
                                     {"head": thead}, device="cpu")
    return jhead, thead, jstate, tstate


def test_cnn_step_matches_jax(scene):
    """One CNN-head step from a fresh state: loss, every group's gradients
    (the moments), the parameters; then the 10-step loss curve."""
    sc = scene
    jhead, thead, jstate, tstate = _cnn_states(sc)
    jstep = jt.make_neural2d_step(sc["cfg"], jhead, PATCH)
    tstep = tt.make_neural2d_step(sc["tcfg"], thead, PATCH)
    heads = {"head": thead}
    jl, tl = [], []
    for i in range(10):
        u = _u(jax.random.split(jstate.key)[1], sc["cfg"])
        jstate, ji = jstep(jstate, sc["st"], sc["grid"], sc["jb"], sc["gt"],
                           jnp.asarray(0))
        tstate, ti = tstep(tstate, sc["tst"], sc["tgrid"], sc["tb"],
                           sc["tgt"], 0, u=u)
        jl.append(float(ji["loss_total"]))
        tl.append(float(ti["loss_total"]))
        if i == 0:
            _close(ti["loss_total"], ji["loss_total"], TOL, "loss")
            _close(ti["psnr"], ji["psnr"], TOL, "psnr")
            _hold_g_side(tstate.params, tstate.opt_state, jstate.params,
                         jstate.opt_state, heads, "CNN step")
    assert int(tstate.step) == 10
    np.testing.assert_allclose(tl, jl, rtol=CURVE_TOL)
    assert tl[-1] < tl[0]


def test_stylegan_step_matches_jax(scene):
    """One StyleGAN2 step on frame 1: the five groups against JAX's; frame
    0's style code bit-equal to the start."""
    sc = scene
    jgen, jvec, tgen, tvec = _stylegan()
    gp, vp = _stylegan_params(jgen, jvec)
    z0 = np.random.RandomState(3).randn(2, 8).astype(np.float32)
    jstate = jt.create_neural2d_state(
        jax.random.PRNGKey(4), *_own(sc), gp, sc["cfg"],
        style_codes=jnp.asarray(z0), stylevec_params=vp)
    heads = {"head": tgen, "stylevec": tvec}
    tstate = neural2d_state_from_jax(_np(jstate), torch.Generator(), heads,
                                     device="cpu")
    u = _u(jax.random.split(jstate.key)[1], sc["cfg"])
    jstep = jt.make_neural2d_step(sc["cfg"], None, PATCH, generator=jgen,
                                  vectorizer=jvec)
    tstep = tt.make_neural2d_step(sc["tcfg"], None, PATCH, generator=tgen,
                                  vectorizer=tvec)
    jstate, ji = jstep(jstate, sc["st"], sc["grid"], sc["jb"], sc["gt"],
                       jnp.asarray(1))
    tstate, ti = tstep(tstate, sc["tst"], sc["tgrid"], sc["tb"], sc["tgt"],
                       1, u=u)
    assert set(tstate.params) == {"mlp", "points", "head", "style",
                                  "stylevec"}
    _close(ti["loss_total"], ji["loss_total"], TOL, "loss")
    _hold_g_side(tstate.params, tstate.opt_state, jstate.params,
                 jstate.opt_state, heads, "StyleGAN2 step")
    z = tstate.params["style"]
    assert torch.equal(z[0], torch.from_numpy(z0[0]))
    assert float((z[1] - torch.from_numpy(z0[1])).abs().max()) > 0


def test_gan_steps_match_jax(scene):
    """Two GAN steps with gp_every 2 (the penalty on the first, not the
    second), JAX's render and augmentation draws: every loss, the G side
    (params, moments), D's params and moments, and the EMA."""
    sc = scene
    jgen, jvec, tgen, tvec = _stylegan()
    jdisc = jn.Discriminator(image_size=PATCH, network_capacity=2)
    tdisc = tn.Discriminator(PATCH, network_capacity=2)
    gp, vp = _stylegan_params(jgen, jvec)
    dp = flax_fill(jdisc, 3, np.zeros((1, PATCH, PATCH, 3)))
    z0 = np.random.RandomState(4).randn(2, 8).astype(np.float32)
    jstate = jt.create_gan_state(jax.random.PRNGKey(5), *_own(sc), gp, dp,
                                 sc["cfg"],
                                 style_codes=jnp.asarray(z0),
                                 stylevec_params=vp)
    heads = {"head": tgen, "stylevec": tvec}
    tstate = gan_state_from_jax(_np(jstate), torch.Generator(), heads, tdisc,
                                device="cpu")
    kw = dict(aug_prob=1.0, gp_every=2)
    jstep = jt.make_gan_step(sc["cfg"], None, PATCH, jdisc, generator=jgen,
                             vectorizer=jvec, **kw)
    tstep = tt.make_gan_step(sc["tcfg"], None, PATCH, tdisc, generator=tgen,
                             vectorizer=tvec, **kw)
    for i in range(2):
        _k, k_render, k_aug_d, k_aug_g, k_render2 = jax.random.split(
            jstate.key, 5)
        draws = {"render": _u(k_render, sc["cfg"]),
                 "render2": _u(k_render2, sc["cfg"]),
                 "aug_d": _aug_draws(k_aug_d, 1.0),
                 "aug_g": _aug_draws(k_aug_g, 1.0)}
        jstate, ji = jstep(jstate, sc["st"], sc["grid"], sc["jb"], sc["gt"],
                           jnp.asarray(1))
        tstate, ti = tstep(tstate, sc["tst"], sc["tgrid"], sc["tb"],
                           sc["tgt"], 1, draws=draws)
        for k in ("loss_total", "loss_recon", "loss_g_adv", "loss_d",
                  "loss_gp", "psnr"):
            if i == 1 and k == "loss_gp":
                assert float(ti[k]) == 0.0 == float(ji[k])
                continue
            _close(ti[k], ji[k], TOL, f"step {i} {k}")
        if i == 0:
            assert float(ti["loss_gp"]) > 0
            _hold_g_side(tstate.params, tstate.g_opt_state, jstate.params,
                         jstate.g_opt_state, heads, "GAN step 0")
            jd_adam = jstate.d_opt_state[0]
            _close_params({"d": tstate.d_opt_state.mu}, {"d": jd_adam.mu},
                          {"d": tdisc}, "D mu")
            _close_params({"d": tstate.d_opt_state.nu}, {"d": jd_adam.nu},
                          {"d": tdisc}, "D nu")
        _close_params({"d": tstate.d_params}, {"d": jstate.d_params},
                      {"d": tdisc}, f"step {i} D params")
        _close_params(tstate.ema, jstate.ema, heads, f"step {i} EMA")
    _close_params(tstate.params, jstate.params, heads, "step 1 G params")
    assert torch.equal(tstate.params["style"][0], torch.from_numpy(z0[0]))


@pytest.mark.parametrize("seed,prob,on,flip", [(2, 0.5, 0, 0),
                                                (3, 1.0, 1, 1),
                                                (7, 1.0, 1, 0)])
def test_diff_augment_matches_jax(seed, prob, on, flip):
    """diff_augment with JAX's draws (flip, translate, cutout in that
    order) on a batch: off, on with the flip, on without it."""
    imgs = np.random.RandomState(7).rand(2, PATCH, PATCH, 3).astype(
        np.float32)
    key = jax.random.PRNGKey(seed)
    d = _aug_draws(key, prob)
    assert (d["on"], d["flip"]) == (on, flip)
    j = np.asarray(jt.diff_augment(key, jnp.asarray(imgs), prob))
    t = tt.diff_augment(torch.tensor(imgs.transpose(0, 3, 1, 2)), d)
    np.testing.assert_array_equal(t.numpy().transpose(0, 2, 3, 1), j)


def test_augment_draws_ranges():
    g = torch.Generator().manual_seed(0)
    draws = [tt.augment_draws(g, 48, 48, 0.5) for _ in range(400)]
    for k, hi in (("on", 1), ("flip", 1), ("tx", 12), ("ty", 12),
                  ("cx", 24), ("cy", 24)):
        vals = {d[k] for d in draws}
        assert min(vals) == 0 and max(vals) == hi, (k, sorted(vals))


def test_n2d_demo_cli():
    """`--n2d-demo --device cpu` trains the CNN head on the sphere and
    prints its losses."""
    r = subprocess.run(
        [sys.executable, "-m", "pointnerf_tpu_torch.train.driver",
         "--n2d-demo", "--device", "cpu", "--steps", "6"],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("[n2d]")]
    assert len(lines) == 2 and "step 5:" in lines[-1], r.stdout
    assert all(np.isfinite(float(ln.split("loss=")[1].split()[0]))
               for ln in lines)


def test_registry_matches_jax():
    """The port's registry: JAX's four names with the same fields, each
    module path the port's counterpart, importable, and the same error for
    an unknown name."""
    import importlib
    from pointnerf_tpu.models import registry as jr
    from pointnerf_tpu_torch.models import registry as trg
    assert sorted(trg.MODEL_REGISTRY) == sorted(jr.MODEL_REGISTRY)
    for name, entry in jr.MODEL_REGISTRY.items():
        port = trg.create_model(name)
        assert set(port) == set(entry), name
        for f in ("trainer", "driver"):
            if f in entry:
                assert port[f] == entry[f].replace("pointnerf_tpu.",
                                                   "pointnerf_tpu_torch.")
                mod, _, fn = port[f].partition(":")
                m = importlib.import_module(mod)
                assert not fn or callable(getattr(m, fn))
    with pytest.raises(KeyError, match="not registered"):
        trg.create_model("nope")
