"""The port's MVS stack (pointnerf_tpu_torch/ops/sample2d.py and mvs/)
against the JAX package's on the CPU, the mirror of tests/test_mvs.py.

The weights are a flax variables tree of MvsPointsInit (its structure from
`jax.eval_shape` of JAX's init) filled from a numpy seed — kernels of
spread 1/sqrt(fan_in), BatchNorm scales near 1 and nonzero biases and
running stats, so that every parameter shapes the output — carried into
the port by `convert.mvs_variables_from_jax`. Sizes: 64 x 32 views, D = 8.

Bars: sampling values and gradients within 1e-6 of scale; the MVSNet
depth max |err| / max |depth| and conf / prob max |err| within 1e-4 (the
bars the JAX package held against the reference's torch MVSNet,
tests/test_mvs_import.py); train-mode batch stats within 1e-5; the
embedding within 2e-4 of scale. Discrete outputs (the filter's masks, the
point counts) are compared exactly, on inputs that the test first shows to
hold a margin from every threshold.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.mvs import filter as jfilter
from pointnerf_tpu.mvs import masking as jmask
from pointnerf_tpu.mvs import mvsnet as jmvs
from pointnerf_tpu.mvs import points_init as jpi
from pointnerf_tpu.ops import sample2d as js2d
from pointnerf_tpu_torch.convert import mvs_variables_from_jax
from pointnerf_tpu_torch.mvs import filter as tfilter
from pointnerf_tpu_torch.mvs import masking as tmask
from pointnerf_tpu_torch.mvs import mvsnet as tmvs
from pointnerf_tpu_torch.mvs import points_init as tpi
from pointnerf_tpu_torch.ops import sample2d as ts2d

SAMPLE_TOL = 1e-6
DEPTH_TOL = 1e-4
STATS_TOL = 1e-5
EMBED_TOL = 2e-4
V, H, W, D = 3, 32, 64, 8
F_DIM = 8


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def jax_mvs_variables(V=V, H=H, W=W, D=D, F=F_DIM, seed=1):
    """A flax variables tree of MvsPointsInit(point_features_dim=F) for V
    views, filled from a numpy seed."""
    model = jpi.MvsPointsInit(point_features_dim=F)

    def init_all(mdl):
        imgs = jnp.zeros((V, H, W, 3))
        eye4 = jnp.stack([jnp.eye(4)] * V)
        _d, _c, feats, _p = mdl.depth_one_view(imgs, eye4,
                                               jnp.linspace(2.0, 6.0, D))
        mdl.embed_points(jnp.zeros((4, 3)), imgs, feats,
                         jnp.stack([jnp.eye(3)] * V), eye4, jnp.zeros(3),
                         jnp.zeros((4, 1)))
    shapes = jax.eval_shape(lambda k: model.init(k, method=init_all),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "scale" in name:
            return (1 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        if "mean" in name:
            return (0.1 * rng.randn(*s.shape)).astype(np.float32)
        if "var" in name:
            return (1 + 0.2 * rng.rand(*s.shape)).astype(np.float32)
        return (0.05 * rng.randn(*s.shape)).astype(np.float32)
    return model, jax.tree_util.tree_map_with_path(fill, shapes)


def cams(V=V, H=H, W=W, baseline=0.1):
    """V cameras along +x looking down +z (tests/test_mvs.py's rig)."""
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    Ks = np.stack([K] * V)
    w2cs = np.stack([np.eye(4, dtype=np.float32)] * V)
    for v in range(V):
        w2cs[v][0, 3] = -baseline * v
    return Ks, w2cs


def port_model(align_corners=True):
    return tpi.MvsPointsInit(point_features_dim=F_DIM,
                             align_corners=align_corners)


@pytest.fixture(scope="module")
def mvs():
    model, variables = jax_mvs_variables()
    return model, variables, mvs_variables_from_jax(variables, device="cpu")


# ---- ops/sample2d --------------------------------------------------------

def _sample_inputs(seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randn(7, 9, 3).astype(np.float32)
    # in and out of the image, on its edges and on integer coordinates
    x = np.concatenate([rng.uniform(-2.0, 10.5, 40), [0.0, 8.0, 3.0, -0.5,
                                                      8.5]]).astype(np.float32)
    y = np.concatenate([rng.uniform(-2.0, 8.5, 40), [0.0, 6.0, 2.0, 6.5,
                                                     -0.5]]).astype(np.float32)
    ct = rng.randn(x.size, 3).astype(np.float32)
    return img, x, y, ct


def test_bilinear_sample_values_and_gradients():
    img, x, y, ct = _sample_inputs()
    out, vjp = jax.vjp(js2d.bilinear_sample, jnp.asarray(img), jnp.asarray(x),
                       jnp.asarray(y))
    g_img, g_x, g_y = vjp(jnp.asarray(ct))
    ti = torch.tensor(img.transpose(2, 0, 1), requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    ty = torch.tensor(y, requires_grad=True)
    tout = ts2d.bilinear_sample(ti, tx, ty)
    assert rel_err(tout.detach().numpy().T, out) <= SAMPLE_TOL
    gi, gx, gy = torch.autograd.grad(tout, (ti, tx, ty),
                                     torch.tensor(ct.T.copy()))
    assert rel_err(gi.numpy().transpose(1, 2, 0), g_img) <= SAMPLE_TOL
    assert rel_err(gx.numpy(), g_x) <= SAMPLE_TOL
    assert rel_err(gy.numpy(), g_y) <= SAMPLE_TOL
    # every out-of-image sample is exactly zero
    far = (x < -1) | (x > 9) | (y < -1) | (y > 7)
    assert far.any() and (tout.detach().numpy()[:, far] == 0).all()


@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_norm_matches_jax(align_corners):
    img, _x, _y, ct = _sample_inputs(1)
    grid = np.random.RandomState(2).uniform(-1.2, 1.2, (45, 2)).astype(
        np.float32)
    out, vjp = jax.vjp(lambda i, g: js2d.grid_sample_norm(i, g, align_corners),
                       jnp.asarray(img), jnp.asarray(grid))
    g_img, g_grid = vjp(jnp.asarray(ct))
    ti = torch.tensor(img.transpose(2, 0, 1), requires_grad=True)
    tg = torch.tensor(grid, requires_grad=True)
    tout = ts2d.grid_sample_norm(ti, tg, align_corners)
    assert rel_err(tout.detach().numpy().T, out) <= SAMPLE_TOL
    gi, gg = torch.autograd.grad(tout, (ti, tg), torch.tensor(ct.T.copy()))
    assert rel_err(gi.numpy().transpose(1, 2, 0), g_img) <= SAMPLE_TOL
    assert rel_err(gg.numpy(), g_grid) <= SAMPLE_TOL


# ---- mvs/mvsnet ----------------------------------------------------------

def test_homo_warp_identity():
    """Warping a view into itself (proj = I) returns the view."""
    feat = np.random.RandomState(0).rand(4, 16, 20).astype(np.float32)
    out = tmvs.homo_warp(torch.tensor(feat), torch.eye(4),
                         torch.tensor([1.0, 2.0, 5.0]))
    for d in range(3):
        np.testing.assert_allclose(out[:, d].numpy(), feat, atol=1e-5)


@pytest.mark.parametrize("align_corners", [True, False])
def test_homo_warp_matches_jax(align_corners):
    """Two views of the rig; the depths include planes behind the source
    camera (z <= 1e-6), which both zero."""
    Ks, w2cs = cams(V=2, H=16, W=20)
    proj = jpi.view_proj_mats(Ks, w2cs, 0)[1]
    proj[2, 3] = -1.5          # pushes the nearer planes behind the camera
    feat = np.random.RandomState(3).randn(16, 20, 4).astype(np.float32)
    dv = np.array([0.5, 1.0, 1.49, 2.0, 4.0, 7.5], np.float32)
    ref = np.asarray(jmvs.homo_warp(jnp.asarray(feat), jnp.asarray(proj),
                                    jnp.asarray(dv), align_corners))
    out = tmvs.homo_warp(torch.tensor(feat.transpose(2, 0, 1)),
                         torch.tensor(proj), torch.tensor(dv),
                         align_corners).numpy().transpose(1, 2, 3, 0)
    assert (ref[:3] == 0).all() and (out[:3] == 0).all()
    assert np.abs(ref[3:]).max() > 0
    assert rel_err(out, ref) <= SAMPLE_TOL


def test_depth_regression_peak():
    prob = np.zeros((8, 4, 4), np.float32)
    prob[3] = 1.0
    dv = torch.linspace(1.0, 8.0, 8)
    d = tmvs.depth_regression(torch.tensor(prob), dv)
    np.testing.assert_allclose(d.numpy(), np.full((4, 4), float(dv[3])),
                               rtol=1e-6)


def _mvs_inputs():
    rng = np.random.RandomState(0)
    imgs = rng.rand(V, H, W, 3).astype(np.float32)
    Ks, w2cs = cams()
    return (imgs, jpi.view_proj_mats(Ks, w2cs, 0),
            np.linspace(2.0, 6.0, D).astype(np.float32))


@pytest.mark.parametrize("train", [False, True])
def test_mvsnet_forward_matches_jax(mvs, train):
    """depth / conf / features / prob (and, in train mode, the updated
    running stats) of MVSNet with the same weights."""
    model, variables, tvars = mvs
    imgs, projs, dv = _mvs_inputs()
    fn = jax.jit(lambda v, i, p, d: model.apply(
        v, i, p, d, train, method=model.depth_one_view,
        mutable=["batch_stats"] if train else False))
    res = fn(variables, jnp.asarray(imgs), jnp.asarray(projs),
             jnp.asarray(dv))
    (d, c, f, p), upd = res if train else (res, None)
    tstats = {k: v.clone() for k, v in tvars["batch_stats"].items()}
    td, tc, tf, tp = tpi.mvs_apply(
        port_model(), {"params": tvars["params"], "batch_stats": tstats},
        tpi.images_nchw(imgs, "cpu"), torch.tensor(projs), torch.tensor(dv),
        train)
    assert td.shape == (H // 4, W // 4) and tp.shape == (D, H // 4, W // 4)
    assert tf.shape == (V, 32, H // 4, W // 4)
    assert rel_err(td, d) <= DEPTH_TOL
    assert np.abs(tc.numpy() - np.asarray(c)).max() <= DEPTH_TOL
    assert np.abs(tp.numpy() - np.asarray(p)).max() <= DEPTH_TOL
    assert rel_err(tf.numpy().transpose(0, 2, 3, 1), f) <= DEPTH_TOL
    np.testing.assert_allclose(tp.sum(0).numpy(), 1.0, atol=1e-5)
    if train:
        jst = mvs_variables_from_jax({"params": {}, "batch_stats": upd[
            "batch_stats"]}, device="cpu")["batch_stats"]
        assert sorted(jst) == sorted(tstats)
        moved = 0
        for k, v in jst.items():
            assert float((tstats[k] - v).abs().max()) <= STATS_TOL, k
            moved += int(not torch.equal(tstats[k], tvars["batch_stats"][k]))
        assert moved == len(jst)      # every BatchNorm folded its stats in
    else:
        # eval mode leaves the stats as they were
        for k, v in tvars["batch_stats"].items():
            assert torch.equal(tstats[k], v)


def test_mvsnet_checks_its_strides():
    with pytest.raises(AssertionError, match="divisible by 32"):
        tmvs.MVSNet()(torch.zeros((2, 3, 48, 64)), torch.eye(4)[None].repeat(
            2, 1, 1), torch.linspace(2.0, 6.0, 8))


def test_conv_transpose_map_matches_jax_deconv():
    """flax's ConvTranspose(transpose_kernel=True, padding (1, 2), stride 2)
    is ConvTranspose3d(k=3, s=2, padding=1, output_padding=1) with the
    kernel transposed (4, 3, 0, 1, 2) and not flipped: the converter's map
    gives JAX's output, and a flipped kernel does not."""
    import flax.linen as fnn
    layer = fnn.ConvTranspose(6, (3, 3, 3), strides=(2, 2, 2),
                              padding=[(1, 2)] * 3, transpose_kernel=True,
                              use_bias=False)
    rng = np.random.RandomState(4)
    x = rng.randn(3, 4, 5, 5).astype(np.float32)           # [D, H, W, in]
    kernel = rng.randn(3, 3, 3, 6, 5).astype(np.float32)  # [*k, out, in]
    ref = np.asarray(layer.apply({"params": {"kernel": kernel}},
                                 jnp.asarray(x)))
    w = mvs_variables_from_jax({"params": {"deconv": {"kernel": kernel}}},
                               device="cpu")["params"]["deconv.weight"]
    conv = torch.nn.ConvTranspose3d(5, 6, 3, stride=2, padding=1,
                                    output_padding=1, bias=False)
    with torch.no_grad():
        conv.weight.copy_(w)
        out = conv(torch.tensor(x.transpose(3, 0, 1, 2))[None])[0]
    out = out.numpy().transpose(1, 2, 3, 0)
    assert out.shape == ref.shape == (6, 8, 10, 6)
    assert rel_err(out, ref) <= 1e-6
    with torch.no_grad():
        conv.weight.copy_(torch.flip(w, (2, 3, 4)))
        flipped = conv(torch.tensor(x.transpose(3, 0, 1, 2))[None])[0]
    assert rel_err(flipped.numpy().transpose(1, 2, 3, 0), ref) > 0.1


# ---- mvs/filter ----------------------------------------------------------

def _filter_inputs():
    """Depth maps of a slanted plane seen by the rig's three views (each
    view's own true depth), with blocks of pixels scaled by 1.5 (far from
    consistent) and a confidence map with values far from the threshold."""
    h, w = 24, 32
    Ks, w2cs = cams(V=3, H=h, W=w, baseline=0.2)
    rng = np.random.RandomState(5)
    depths, confs = [], []
    for v in range(3):
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
        # the plane z = 4 + 0.02 * X in world, X = (x - cx) z / f - t
        f, cx = float(Ks[v][0, 0]), float(Ks[v][0, 2])
        t = float(-w2cs[v][0, 3])
        z = (4.0 + 0.02 * t) / (1.0 - 0.02 * (xs - cx) / f)
        z = z.astype(np.float32)
        bad = np.zeros((h, w), bool)
        bad[rng.randint(0, h, 6), rng.randint(0, w, 6)] = True
        bad[:4, 10 * v:10 * v + 6] = True
        depths.append(np.where(bad, z * 1.5, z).astype(np.float32))
        confs.append(np.where(rng.rand(h, w) < 0.8, 0.95, 0.3).astype(
            np.float32))
    return depths, confs, list(Ks), list(w2cs)


def _jax_pair_margins(depths, Ks, w2cs):
    """The smallest distance of any pixel's dist and rel_diff (JAX's, for
    every ordered pair) from their thresholds 1.0 and 0.01."""
    m_dist, m_rel = np.inf, np.inf
    for r in range(3):
        for s in range(3):
            if r == s:
                continue
            d_rep, xr, yr, _ = jfilter.reproject_with_depth(
                jnp.asarray(depths[r]), jnp.asarray(Ks[r]),
                jnp.asarray(w2cs[r]), jnp.asarray(depths[s]),
                jnp.asarray(Ks[s]), jnp.asarray(w2cs[s]))
            hh, ww = depths[r].shape
            yy, xx = np.mgrid[0:hh, 0:ww]
            dist = np.sqrt((np.asarray(xr) - xx) ** 2
                           + (np.asarray(yr) - yy) ** 2)
            rel = np.abs(np.asarray(d_rep) - depths[r]) / depths[r]
            m_dist = min(m_dist, float(np.abs(dist - 1.0).min()))
            m_rel = min(m_rel, float(np.abs(rel - 0.01).min()))
    return m_dist, m_rel


def test_geometric_consistency_masks_match_jax():
    depths, _c, Ks, w2cs = _filter_inputs()
    # margins far above the f32 rounding of dist (~1e-6 px) and rel_diff
    # (~1e-9 at 0.01)
    m_dist, m_rel = _jax_pair_margins(depths, Ks, w2cs)
    assert m_dist > 1e-4 and m_rel > 1e-6, (m_dist, m_rel)
    n_geo = 0
    for r, s in ((0, 1), (1, 0), (0, 2), (2, 1)):
        geo, vis, d_rep = jfilter.check_geometric_consistency(
            *[jnp.asarray(a) for a in (depths[r], Ks[r], w2cs[r], depths[s],
                                       Ks[s], w2cs[s])])
        tgeo, tvis, td = tfilter.check_geometric_consistency(
            *[torch.tensor(a) for a in (depths[r], Ks[r], w2cs[r], depths[s],
                                        Ks[s], w2cs[s])])
        np.testing.assert_array_equal(tgeo.numpy(), np.asarray(geo))
        np.testing.assert_array_equal(tvis.numpy(), np.asarray(vis))
        assert rel_err(td.numpy(), d_rep) <= SAMPLE_TOL
        n_geo += int(np.asarray(geo).sum())
        assert 0 < np.asarray(geo).sum() < geo.size
    assert n_geo > 0


@pytest.mark.parametrize("with_masks", [False, True])
def test_filter_by_masks_matches_jax(with_masks):
    depths, confs, Ks, w2cs = _filter_inputs()
    masks = None
    if with_masks:
        masks = [np.random.RandomState(9 + v).rand(*depths[0].shape) < 0.7
                 for v in range(3)]
    jx, jc = jfilter.filter_by_masks(depths, confs, Ks, w2cs,
                                     depth_conf_thresh=0.8, geo_cnsst_num=1,
                                     masks=masks)
    tx, tc = tfilter.filter_by_masks(depths, confs, Ks, w2cs,
                                     depth_conf_thresh=0.8, geo_cnsst_num=1,
                                     masks=masks, device="cpu")
    for v in range(3):
        assert tx[v].shape == jx[v].shape and jx[v].shape[0] > 0
        assert rel_err(tx[v], jx[v]) <= SAMPLE_TOL
        np.testing.assert_array_equal(tc[v], jc[v])
    # geo_cnsst_num 2 keeps fewer, still equal
    jx2, _ = jfilter.filter_by_masks(depths, confs, Ks, w2cs, 0.8, 2,
                                     masks=masks)
    tx2, _ = tfilter.filter_by_masks(depths, confs, Ks, w2cs, 0.8, 2,
                                     masks=masks, device="cpu")
    assert [a.shape for a in tx2] == [a.shape for a in jx2]
    assert sum(a.shape[0] for a in jx2) < sum(a.shape[0] for a in jx)


# ---- mvs/points_init -----------------------------------------------------

def test_view_proj_mats_bit_equal():
    Ks, w2cs = cams()
    w2cs[1][:3, :3] = np.array([[0.99, -0.1, 0], [0.1, 0.99, 0], [0, 0, 1]])
    for ref in range(V):
        np.testing.assert_array_equal(tpi.view_proj_mats(Ks, w2cs, ref),
                                      jpi.view_proj_mats(Ks, w2cs, ref))


def test_embed_points_matches_jax(mvs):
    model, variables, tvars = mvs
    rng = np.random.RandomState(6)
    imgs = rng.rand(V, H, W, 3).astype(np.float32)
    feats = rng.randn(V, H // 4, W // 4, 32).astype(np.float32)
    Ks, w2cs = cams()
    xyz = np.stack([rng.uniform(-0.6, 0.6, 50), rng.uniform(-0.3, 0.3, 50),
                    rng.uniform(2.5, 5.0, 50)], -1).astype(np.float32)
    conf = rng.rand(50, 1).astype(np.float32)
    campos = np.linalg.inv(w2cs[0])[:3, 3]
    ref = model.apply(variables, *[jnp.asarray(a) for a in (
        xyz, imgs, feats, Ks, w2cs, campos, conf)],
        method=model.embed_points)
    out = tpi.mvs_apply(port_model(), tvars, torch.tensor(xyz),
                        tpi.images_nchw(imgs, "cpu"),
                        torch.tensor(feats.transpose(0, 3, 1, 2).copy()),
                        torch.tensor(Ks), torch.tensor(w2cs),
                        torch.tensor(campos), torch.tensor(conf),
                        method="embed_points")
    for name, a, b in zip(("embedding", "color", "dirs", "conf"), out, ref):
        assert rel_err(a.detach().numpy(), b) <= EMBED_TOL, name


class _Inject:
    """Replaces the depth and conf maps of depth_one_view's calls, in call
    order (gen_scene_points calls it once per reference view)."""

    def __init__(self, maps):
        self.maps = maps
        self.i = 0

    def next(self):
        d, c = self.maps[self.i % len(self.maps)]
        self.i += 1
        return d, c


def test_gen_scene_points_with_injected_depths(mvs, monkeypatch):
    """The same depth and conf maps injected into both pipelines (so no
    MVSNet rounding decides a mask): the same point count, points equal to
    within f32 rounding, payloads within the embedding bar."""
    model, variables, tvars = mvs
    h, w = H // 4, W // 4
    Ks, w2cs = cams(baseline=0.2)
    # the filter's rig at feature resolution: the slanted plane of
    # _filter_inputs at h x w pixels
    rng = np.random.RandomState(7)
    maps = []
    for v in range(V):
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
        f, cx = float(Ks[v][0, 0]) * h / H, float(Ks[v][0, 2]) * h / H
        t = float(-w2cs[v][0, 3])
        z = ((4.0 + 0.02 * t) / (1.0 - 0.02 * (xs - cx) / f)).astype(
            np.float32)
        z[rng.rand(h, w) < 0.2] *= 1.5
        maps.append((z, np.where(rng.rand(h, w) < 0.8, 0.9,
                                 0.1).astype(np.float32)))
    j_inj, t_inj = _Inject(maps), _Inject(maps)
    j_orig = jpi.MvsPointsInit.depth_one_view
    t_orig = tpi.MvsPointsInit.depth_one_view

    def j_patch(self, *a, **k):
        _d, _c, feats, prob = j_orig(self, *a, **k)
        d, c = j_inj.next()
        return jnp.asarray(d), jnp.asarray(c), feats, prob

    def t_patch(self, *a, **k):
        _d, _c, feats, prob = t_orig(self, *a, **k)
        d, c = t_inj.next()
        return torch.tensor(d), torch.tensor(c), feats, prob
    monkeypatch.setattr(jpi.MvsPointsInit, "depth_one_view", j_patch)
    monkeypatch.setattr(tpi.MvsPointsInit, "depth_one_view", t_patch)
    imgs = rng.rand(V, H, W, 3).astype(np.float32)
    kw = dict(n_depths=D, depth_conf_thresh=0.5, geo_cnsst_num=1)
    jout = jpi.gen_scene_points(variables["params"], model, imgs, Ks, w2cs,
                                (2.0, 6.0), batch_stats=variables[
                                    "batch_stats"], **kw)
    tout = tpi.gen_scene_points(tvars["params"], port_model(), imgs, Ks,
                                w2cs, (2.0, 6.0),
                                batch_stats=tvars["batch_stats"], **kw)
    assert j_inj.i == t_inj.i == V
    n = jout["xyz"].shape[0]
    assert n > 0 and tout["xyz"].shape[0] == n
    assert rel_err(tout["xyz"], jout["xyz"]) <= SAMPLE_TOL
    np.testing.assert_array_equal(tout["conf"], jout["conf"])
    for k in ("embedding", "color", "dirs"):
        assert tout[k].shape == jout[k].shape
        assert rel_err(tout[k], jout[k]) <= EMBED_TOL, k


def test_gen_scene_points_end_to_end(mvs):
    """The whole pipeline with the carried weights (tests/test_mvs.py's
    plumbing check): well-formed, finite payloads."""
    _model, _variables, tvars = mvs
    imgs, _p, _dv = _mvs_inputs()
    Ks, w2cs = cams()
    out = tpi.gen_scene_points(tvars["params"], port_model(), imgs, Ks, w2cs,
                               (2.0, 6.0), n_depths=D, depth_conf_thresh=0.0,
                               geo_cnsst_num=1,
                               batch_stats=tvars["batch_stats"])
    n = out["xyz"].shape[0]
    assert n > 0
    assert out["embedding"].shape == (n, F_DIM)
    for k in ("color", "dirs"):
        assert out[k].shape == (n, 3)
    assert out["conf"].shape == (n, 1)
    for v in out.values():
        assert np.isfinite(v).all()


def test_init_mvs_points_draws_flax_distributions():
    """The port's own seeded init: kernels lecun-normal (truncated at
    2 std), zero biases, BatchNorm scale 1 / bias 0 / stats 0 and 1; the
    same seed gives the same weights."""
    a = tpi.init_mvs_points(port_model(), torch.Generator().manual_seed(0))
    b = tpi.init_mvs_points(port_model(), torch.Generator().manual_seed(0))
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k])
    w = a["params"]["mvsnet.cost_regularization.conv0.conv.weight"]
    std = np.sqrt(1.0 / (32 * 27)) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std + 1e-7
    assert abs(float(w.std()) / std - 0.88) < 0.05
    assert float(a["params"]["mvsnet.cost_regularization.prob.bias"].abs()
                 .max()) == 0.0
    bn = "mvsnet.feature.conv0.bn."
    assert torch.equal(a["params"][bn + "weight"], torch.ones(8))
    assert torch.equal(a["batch_stats"][bn + "running_var"], torch.ones(8))


# ---- mvs/masking ---------------------------------------------------------

def test_alpha_masking_and_bg_points_match_jax():
    rng = np.random.RandomState(8)
    Ks, w2cs = cams()
    pts = np.stack([rng.uniform(-1.5, 1.5, 200), rng.uniform(-1, 1, 200),
                    rng.uniform(0.5, 7.0, 200)], -1).astype(np.float32)
    alphas = [rng.rand(H, W).astype(np.float32) for _ in range(V)]
    for nf, keep in (((2.0, 6.0), True), (None, False)):
        np.testing.assert_array_equal(
            tmask.alpha_masking(pts, alphas, Ks, w2cs, nf, 0.3, keep),
            jmask.alpha_masking(pts, alphas, Ks, w2cs, nf, 0.3, keep))
    raydir = rng.randn(64, 3).astype(np.float32)
    campos = np.array([0.1, -0.2, 0.3], np.float32)
    pp, nn_ = np.array([0, 0, 5.0], np.float32), np.array([0, 0.6, 0.8],
                                                          np.float32)
    jp, jv = jmask.gen_bg_points(campos, raydir, pp, nn_)
    tp, tv = tmask.gen_bg_points(campos, raydir, pp, nn_)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert 0 < int(tv.sum()) < 64
    assert rel_err(tp.numpy(), jp) <= SAMPLE_TOL


# ---- mvs/torch_import ----------------------------------------------------

def _reference_state_dict(seed=10):
    """A state dict in the reference MVSNet's layout: the port's MVSNet
    names with the deconvolution blocks as nn.Sequential .0 / .1, a
    DataParallel prefix, num_batches_tracked counters and a refine_network
    entry (both ignored)."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in tmvs.MVSNet().state_dict().items():
        for blk in ("conv7", "conv9", "conv11"):
            k = k.replace(f"{blk}.deconv.", f"{blk}.0.").replace(
                f"{blk}.bn.", f"{blk}.1.")
        val = rng.randn(*v.shape).astype(np.float32)
        if k.endswith("running_var"):
            val = np.abs(val) + 0.5
        sd["module." + k] = torch.tensor(val)
        if k.endswith("running_var"):
            sd["module." + k.replace("running_var", "num_batches_tracked")] = \
                torch.tensor(7)
    sd["module.refine_network.conv1.weight"] = torch.zeros(3)
    return sd


def test_torch_import_matches_jax_conversion(tmp_path):
    from pointnerf_tpu.mvs.torch_import import \
        convert_mvsnet_state_dict as jconvert
    from pointnerf_tpu_torch.mvs import torch_import as ti
    sd = _reference_state_dict()
    jv = mvs_variables_from_jax(jconvert(sd), device="cpu")
    tv = ti.convert_mvsnet_state_dict(sd)
    for g in ("params", "batch_stats"):
        assert sorted(tv[g]) == sorted(jv[g])
        for k in jv[g]:
            assert torch.equal(tv[g][k], jv[g][k]), k
    # the whole MVSNet loads it, and a saved checkpoint goes the same way
    net = tmvs.MVSNet()
    net.load_state_dict({**tv["params"], **tv["batch_stats"]})
    path = str(tmp_path / "mvsnet.ckpt")
    torch.save({"network_state_dict": sd}, path)
    variables = tpi.init_mvs_points(port_model(align_corners=False),
                                    torch.Generator().manual_seed(0))
    out = tpi.load_pretrained_mvsnet(variables, path,
                                     port_model(align_corners=False))
    k = "mvsnet.cost_regularization.conv7.deconv.weight"
    assert torch.equal(out["params"][k], tv["params"][k[7:]])
    assert torch.equal(out["params"]["premlp.0.weight"],
                       variables["params"]["premlp.0.weight"])
    with pytest.raises(ValueError, match="align_corners=False"):
        tpi.load_pretrained_mvsnet(variables, path, port_model(True))
    assert os.path.exists(path)
