"""The port's MVSNeRF volume renderer (pointnerf_tpu_torch/mvs/mvsnerf.py)
against the JAX package's (pointnerf_tpu/mvs/mvsnerf.py), with a seeded
fill of flax's parameter trees (`flax_fill`) carried over by
`convert.mvsnerf_from_flax`, on seeded numpy inputs: every decoder of
MVSNERF_DECODERS (v0, v1, v2, color_fusion) through ReferenceMVSNeRF and on
its own, the compact MVSNeRFDecoder, `trilinear_sample_volume`,
`world_to_ref_ndc`, and `render_mvsnerf` evenly spaced and jittered (JAX's
uniform draw fed to the port). Bars: the decoders, the sampled features
and the render within 2e-4 of scale (the repo's aggregator bar); the march
of the render, given JAX's decoder output, within 1e-5 (the march bar)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.mvs import mvsnerf as jm
from pointnerf_tpu_torch.convert import mvsnerf_from_flax
from pointnerf_tpu_torch.mvs import mvsnerf as tm
from test_torch_neural_render import flax_fill

TOL = 2e-4
MARCH_TOL = 1e-5
R, S, V = 6, 8, 3
D_VOL, HV, WV, C_VOL = 6, 5, 7, 8
H_IMG, W_IMG = 12, 16
NEAR, FAR = 1.0, 3.0
DEPTH, WIDTH = 6, 32           # the decoders' depth (a skip at layer 4)


def _close(a, b, tol, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-12)
    err = float(np.abs(a - b).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def _feat_ch(net_type):
    return C_VOL + (4 if net_type in ("v1", "color_fusion") else 3) * V


def _pair(net_type, seed=0):
    """The JAX ReferenceMVSNeRF, its filled parameters, and the port's
    module with them."""
    jmod = jm.ReferenceMVSNeRF(net_type=net_type, D=DEPTH, W=WIDTH,
                               n_views=V)
    zeros = np.zeros((2, 3, 3), np.float32)
    params = flax_fill(jmod, seed, zeros, zeros,
                       np.zeros((2, 3, _feat_ch(net_type)), np.float32))
    tmod = tm.ReferenceMVSNeRF(net_type=net_type, D=DEPTH, W=WIDTH,
                               n_views=V)
    tmod.load_state_dict(mvsnerf_from_flax(
        tmod, jax.tree.map(np.asarray, params), "cpu"))
    return jmod, params, tmod


@pytest.mark.parametrize("net_type", sorted(tm.MVSNERF_DECODERS))
def test_decoders_match_jax(net_type):
    """Each net_type through ReferenceMVSNeRF ([R, S, .] and the flat
    [N, .] call), and its decoder on the packed input alone; the feature
    channels in [0, 1] and the rgba validity channels 0 / 1, as the render
    packs them."""
    rng = np.random.RandomState(1)
    xyz = rng.uniform(-1, 1, (R, S, 3)).astype(np.float32)
    dirs = rng.normal(size=(R, S, 3)).astype(np.float32)
    feat = rng.rand(R, S, _feat_ch(net_type)).astype(np.float32)
    if net_type in ("v1", "color_fusion"):
        feat[..., C_VOL + 3::4] = rng.rand(R, S, V) > 0.3
    jmod, params, tmod = _pair(net_type)
    want = jmod.apply({"params": params}, xyz, dirs, feat)
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, (xyz, dirs, feat)))
        flat = tmod(*[torch.from_numpy(a.reshape(R * S, -1))
                      for a in (xyz, dirs, feat)])
    _close(got, want, TOL, f"{net_type} output")
    _close(flat, np.asarray(want).reshape(R * S, -1), TOL, f"{net_type} flat")
    # the decoder on its own: x = [PE(xyz) | feat | PE(dir)]
    x = jnp.concatenate([jm.positional_encoding(jnp.asarray(xyz), 10, True),
                         jnp.asarray(feat),
                         jm.positional_encoding(jnp.asarray(dirs), 4, True)],
                        -1)
    kw = {"n_views": V} if net_type in ("v1", "color_fusion") else {}
    jdec = jm.MVSNERF_DECODERS[net_type](
        D=DEPTH, W=128 if net_type == "color_fusion" else WIDTH,
        in_ch_pts=63, in_ch_views=27, **kw)
    with torch.no_grad():
        raw = tmod.nerf(torch.from_numpy(np.array(x)))
    _close(raw, jdec.apply({"params": params["nerf"]}, x), TOL,
           f"{net_type} decoder")


def test_compact_decoder_matches_jax():
    rng = np.random.RandomState(2)
    xyz = rng.uniform(-1, 1, (R, S, 3)).astype(np.float32)
    dirs = rng.normal(size=(R, S, 3)).astype(np.float32)
    feat = rng.rand(R, S, 11).astype(np.float32)
    jmod = jm.MVSNeRFDecoder(depth=DEPTH, width=WIDTH)
    params = flax_fill(jmod, 3, xyz, dirs, feat)
    tmod = tm.MVSNeRFDecoder(11, depth=DEPTH, width=WIDTH)
    tmod.load_state_dict(mvsnerf_from_flax(
        tmod, jax.tree.map(np.asarray, params), "cpu"))
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, (xyz, dirs, feat)))
    _close(got, jmod.apply({"params": params}, xyz, dirs, feat), TOL,
           "MVSNeRFDecoder")


def test_attention_decoders_refuse_rgb_tokens():
    _jmod, _p, tmod = _pair("color_fusion")
    x = torch.zeros((R, S, 3))
    with pytest.raises(ValueError, match="rgba view tokens"):
        tmod(x, x, torch.zeros((R, S, C_VOL + 3 * V)))


def test_trilinear_sample_and_ndc_match_jax():
    rng = np.random.RandomState(4)
    vol = rng.normal(size=(D_VOL, HV, WV, C_VOL)).astype(np.float32)
    # inside, on the faces and outside the volume
    ndc = rng.uniform(-0.2, 1.2, (R, S, 3)).astype(np.float32)
    ndc[0, :3] = [[0, 0, 0], [1, 1, 1], [0.5, 1, 0]]
    got = tm.trilinear_sample_volume(torch.from_numpy(vol),
                                     torch.from_numpy(ndc))
    _close(got, jm.trilinear_sample_volume(jnp.asarray(vol),
                                           jnp.asarray(ndc)), 1e-6,
           "trilinear")
    Ks, w2cs, _campos, _dirs = _cameras(rng)
    xyz = rng.normal(size=(R, S, 3)).astype(np.float32)
    got = tm.world_to_ref_ndc(torch.from_numpy(xyz), torch.from_numpy(w2cs[0]),
                              torch.from_numpy(Ks[0]), NEAR, FAR, W_IMG,
                              H_IMG)
    _close(got, jm.world_to_ref_ndc(jnp.asarray(xyz), jnp.asarray(w2cs[0]),
                                    jnp.asarray(Ks[0]), NEAR, FAR, W_IMG,
                                    H_IMG), 1e-5, "world_to_ref_ndc")


def _cameras(rng):
    """V cameras looking at the origin from about 2 units, their rays
    through the reference view's pixels."""
    Ks, w2cs = [], []
    for v in range(V):
        th = 0.3 * (v - 1)
        c = np.array([2.0 * np.sin(th), 0.1 * v, -2.0 * np.cos(th)])
        fwd = -c / np.linalg.norm(c)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        Rw = np.stack([right, down, fwd])            # world -> camera rows
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = Rw, -Rw @ c
        w2cs.append(w2c)
        Ks.append([[14.0, 0, W_IMG / 2], [0, 14.0, H_IMG / 2], [0, 0, 1]])
    Ks = np.asarray(Ks, np.float32)
    w2cs = np.asarray(w2cs, np.float32)
    c2w = np.linalg.inv(w2cs[0].astype(np.float64))
    pix = np.stack([rng.uniform(0, W_IMG, R), rng.uniform(0, H_IMG, R),
                    np.ones(R)], -1)
    dirs = (pix @ np.linalg.inv(Ks[0]).T) @ c2w[:3, :3].T
    return Ks, w2cs, c2w[:3, 3].astype(np.float32), dirs.astype(np.float32)


class _JaxRecorder:
    """A JAX decoder whose apply records its input features and output."""

    def __init__(self, mod):
        self.mod, self.seen = mod, {}

    def apply(self, variables, xyz, dirs, feat):
        self.seen["feat"] = np.asarray(feat)
        out = self.mod.apply(variables, xyz, dirs, feat)
        self.seen["raw"] = np.asarray(out)
        return out


class _Fixed(torch.nn.Module):
    """A decoder that records the port's features and returns `raw`."""

    def __init__(self, raw):
        super().__init__()
        self.raw, self.seen = raw, {}

    def forward(self, xyz, dirs, feat):
        self.seen["feat"] = feat
        return self.raw


@pytest.mark.parametrize("net_type,jitter,rgba",
                         [("v2", False, False), ("v2", True, False),
                          ("v1", True, True), ("color_fusion", False, True)])
def test_render_mvsnerf_matches_jax(net_type, jitter, rgba):
    """render_mvsnerf at the JAX defaults' layout (ReferenceMVSNeRF, 3 views)
    and a small size, evenly spaced and with JAX's jitter draw fed in as
    `u`: the features the decoder reads, the render (rgb, depth, weights)
    within 2e-4 of scale, and the march on JAX's decoder output within
    1e-5; on the CPU the plain march."""
    rng = np.random.RandomState(5)
    vol = rng.normal(size=(D_VOL, HV, WV, C_VOL)).astype(np.float32)
    imgs = rng.rand(V, H_IMG, W_IMG, 3).astype(np.float32)
    Ks, w2cs, campos, raydir = _cameras(rng)
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    jmod, params, tmod = _pair(net_type)
    key = jax.random.PRNGKey(7) if jitter else None
    rec = _JaxRecorder(jmod)
    jargs = [jnp.asarray(a) for a in (vol, imgs, Ks, w2cs, campos, raydir)]
    want = jm.render_mvsnerf(params, rec, *jargs, NEAR, FAR, n_samples=S,
                             bg_color=jnp.asarray(bg), key=key,
                             per_view_rgba=rgba)
    u = (torch.from_numpy(np.asarray(jax.random.uniform(key, (R, S))))
         if jitter else None)
    targs = [torch.from_numpy(a) for a in (vol, imgs, Ks, w2cs, campos,
                                           raydir)]
    kw = dict(n_samples=S, bg_color=torch.from_numpy(bg), u=u,
              per_view_rgba=rgba)
    with torch.no_grad():
        got = tm.render_mvsnerf(tmod, *targs, NEAR, FAR, **kw)
        fixed = _Fixed(torch.from_numpy(rec.seen["raw"]))
        marched = tm.render_mvsnerf(fixed, *targs, NEAR, FAR, **kw)
    _close(fixed.seen["feat"], rec.seen["feat"], TOL, "features")
    for name, a, b in zip(("rgb", "depth", "weights"), got, want):
        _close(a, b, TOL, name)
    for name, a, b in zip(("march rgb", "march depth", "march weights"),
                          marched, want):
        _close(a, b, MARCH_TOL, name)
    assert float(np.asarray(want[2]).sum(-1).max()) > 0.1   # rays hit


def test_render_mvsnerf_refuses_rgb_tokens_for_attention():
    _jmod, _p, tmod = _pair("v1")
    z = torch.zeros
    with pytest.raises(ValueError, match="per_view_rgba"):
        tm.render_mvsnerf(tmod, z((D_VOL, HV, WV, C_VOL)),
                          z((V, H_IMG, W_IMG, 3)), z((V, 3, 3)),
                          z((V, 4, 4)), z(3), z((R, 3)), NEAR, FAR)


@pytest.mark.parametrize("train", [False, True])
def test_render_mvsnerf_march_follows_the_card_rule(monkeypatch, train):
    """On a faked CUDA device `render_mvsnerf` marches by
    `renderer.march_takes_kernel`: serving (train False) calls K2 once even
    outside torch.no_grad with a decoder whose parameters require grad, and
    gives the plain march's colors; training calls no K2 and carries the
    gradient into the decoder, as JAX's plain march does."""
    from pointnerf_tpu_torch.models import renderer
    rng = np.random.RandomState(5)
    vol = rng.normal(size=(D_VOL, HV, WV, C_VOL)).astype(np.float32)
    imgs = rng.rand(V, H_IMG, W_IMG, 3).astype(np.float32)
    targs = [torch.from_numpy(a) for a in (vol, imgs, *_cameras(rng))]
    _jmod, _p, tmod = _pair("v2")
    calls = []
    real = tm.fused_march
    monkeypatch.setattr(tm, "fused_march",
                        lambda *a: calls.append(a) or real(*a))
    monkeypatch.setattr(tm, "march_takes_kernel",
                        lambda cfg, dev, tr: renderer.march_takes_kernel(
                            cfg, torch.device("cuda"), tr))
    rgb, _depth, w = tm.render_mvsnerf(tmod, *targs, NEAR, FAR, n_samples=S,
                                       train=train)
    with torch.no_grad():
        monkeypatch.setattr(tm, "march_takes_kernel", renderer.
                            march_takes_kernel)
        plain = tm.render_mvsnerf(tmod, *targs, NEAR, FAR, n_samples=S)
    assert len(calls) == (0 if train else 1)
    assert rgb.requires_grad == train
    _close(rgb.detach(), plain[0], MARCH_TOL, "rgb")
    _close(w.detach(), plain[2], MARCH_TOL, "weights")
    if train:
        rgb.sum().backward()
        assert all(p.grad is not None for p in tmod.parameters()
                   if p.requires_grad)
