"""The live-group list of the f32 decode kernels (K3 and K4 on the CUDA
cores decode only the shading groups it lists) and the premise it rests on,
on the CPU.

- `live_groups_plain` (ops/fused_decode.py) against a numpy reference:
  no group live, every group live, one live group in the last tile, random
  weights, and K4's rule (a nonzero upstream gradient makes a group live),
  for K in {4, 8}.
- The premise, on the dataset path: a dense f32 train step at the tiny
  scene_config of tests/test_torch_dataset_driver.py (the fused flag set, so
  that the CPU runs the kernels' plain versions) gives exactly zero g_fagg
  and g_alpha to every group whose K weights are all zero (the aggregator's
  `out * ray_valid`), so K3's list and K4's list are the same there.
- On that step's recorded inputs, JAX's `fused_decode` and its custom VJP
  (Pallas interpret mode) and the port's plain versions give exactly zero
  fagg, alpha and row gradients on those groups, and agree within 2e-4 of
  each output's scale elsewhere.
- The f32 kernels' shared-memory formulas, weight packing and envelope:
  `kernel_takes` takes every spec the first f32 kernels took."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.ops.pallas_decode import DecodeSpec as JSpec
from pointnerf_tpu.ops.pallas_decode import fused_decode as j_fused_decode
from pointnerf_tpu_torch import config as tcfg
from pointnerf_tpu_torch.models.aggregator import decode_spec
from pointnerf_tpu_torch.ops import fused_decode as fd
from pointnerf_tpu_torch.train import driver as td
from test_torch_dataset_driver import _tiny_cfg, scene  # noqa: F401

F32_TOL = 2e-4


def _live_numpy(w, K, gf=None, ga=None):
    G = w.shape[0] // K
    out = []
    for g in range(G):
        live = bool((w[g * K:(g + 1) * K] != 0).any())
        if gf is not None:
            live = live or bool((gf[g] != 0).any()) or bool(ga[g, 0] != 0)
        if live:
            out.append(g)
    return np.asarray(out, np.int32)


def _weights(case, K, G, rng):
    w = np.zeros((G * K, 1), np.float32)
    if case == "all":
        w[:] = rng.rand(G * K, 1) + 0.1
    elif case == "last_tile_single":
        # one live row, the last of the last group (the last 64-row tile)
        w[-1] = 0.5
    elif case == "random":
        w[:] = rng.rand(G * K, 1) * (rng.rand(G * K, 1) > 0.9)
    elif case == "one_per_ray":
        # dense [R, SR, K] rows: one live slot per ray, one weight in it
        R, SR = 7, G // 7
        for r in range(R):
            s = rng.randint(SR)
            w[(r * SR + s) * K + rng.randint(K)] = rng.rand() + 0.1
    return w


@pytest.mark.parametrize("K", [4, 8])
@pytest.mark.parametrize("case", ["none", "all", "last_tile_single",
                                  "random", "one_per_ray"])
def test_live_groups_plain_matches_numpy(case, K):
    rng = np.random.RandomState(K)
    G = 7 * 23                     # a ragged last 64-row tile at K 4 and 8
    w = _weights(case, K, G, rng)
    got = fd.live_groups_plain(torch.from_numpy(w), K)
    want = _live_numpy(w, K)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    expect = {"none": 0, "all": G, "last_tile_single": 1}
    if case in expect:
        assert len(want) == expect[case]
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(fd.live_groups(torch.from_numpy(w), K), got)


@pytest.mark.parametrize("K", [4, 8])
def test_live_groups_plain_k4_rule(K):
    """K4's rule: a group without weight is live when g_fagg or g_alpha has
    a nonzero element there."""
    rng = np.random.RandomState(3)
    G, H = 90, 32
    w = _weights("random", K, G, rng)
    gf = np.zeros((G, H), np.float32)
    ga = np.zeros((G, 1), np.float32)
    gf[rng.choice(G, 10, replace=False), rng.randint(H)] = 1.0
    ga[rng.choice(G, 10, replace=False)] = -2.0
    got = fd.live_groups_plain(torch.from_numpy(w), K, torch.from_numpy(gf),
                               torch.from_numpy(ga))
    np.testing.assert_array_equal(got.numpy(), _live_numpy(w, K, gf, ga))
    assert len(got) > len(fd.live_groups_plain(torch.from_numpy(w), K))


@pytest.fixture
def dense_step(scene, monkeypatch):  # noqa: F811
    """One train step of train_dataset_scene at the tiny scene_config, the
    fused flag set: the decode backward's arguments (the forward's inputs,
    the weights and the upstream gradients) as the step called it."""
    cfg = _tiny_cfg()
    cfg = cfg.replace(agg=dataclasses.replace(cfg.agg, fused_decode=True))
    pcfg = tcfg.PointNeRFConfig.from_json(cfg.to_json())
    seen = []
    real = fd.fused_decode_bwd

    def rec(*a, **k):
        seen.append(a)
        return real(*a, **k)
    monkeypatch.setattr(fd, "fused_decode_bwd", rec)
    td.train_dataset_scene("nerf_synth360_ft", str(scene), "lego",
                           run_dir=str(scene / "run"), max_steps=1, cfg=pcfg,
                           resume=False, device="cpu")
    assert len(seen) == 1
    feat, dists, extras, w, params, spec, gf, ga = seen[0]
    assert not spec.bf16 and spec == decode_spec(pcfg.agg, spec.K, False)
    assert feat.shape[0] == 36 * pcfg.query.SR * pcfg.query.K   # dense
    det = [t.detach().clone() for t in (feat, dists, extras, w, gf, ga)]
    params = jax.tree.map(lambda t: t.detach().clone(), params)
    return det[:4], params, spec, det[4], det[5]


def _dead(w, K):
    return (w.reshape(-1, K) == 0).all(1)


def test_dead_groups_get_no_upstream_gradient(dense_step):
    (_f, _d, _e, w), _p, spec, gf, ga = dense_step
    dead = _dead(w, spec.K)
    assert bool(dead.any()) and bool((~dead).any())
    assert not bool(gf[dead].any()) and not bool(ga[dead].any())
    assert bool(gf[~dead].any())
    # so K4's list is K3's on the dataset path
    assert torch.equal(fd.live_groups_plain(w, spec.K, gf, ga),
                       fd.live_groups_plain(w, spec.K))


def _rows(t, dead, K):
    return t.reshape(dead.shape[0], K, -1)[dead]


def test_jax_and_plain_decode_are_zero_on_dead_groups(dense_step):
    ins, params, spec, gf, ga = dense_step
    K = spec.K
    dead = _dead(ins[3], K)
    jspec = JSpec(**spec._asdict(), interpret=True, tile_rows=64)
    jp = jax.tree.map(lambda t: jnp.array(t.numpy(), copy=True), params)
    (fj, aj), vjp = jax.vjp(
        lambda a, b, c, d, p: j_fused_decode(a, b, c, d, p, jspec),
        *[jnp.array(t.numpy(), copy=True) for t in ins], jp)
    gj = jax.block_until_ready(vjp((jnp.array(gf.numpy(), copy=True),
                                    jnp.array(ga.numpy(), copy=True))))
    ft, at = fd.fused_decode_plain(*ins, params, spec)
    gt = fd.fused_decode_bwd_plain(*ins, params, spec, gf, ga)

    fj, aj = torch.tensor(np.asarray(fj)), torch.tensor(np.asarray(aj))
    for a, b in ((ft, fj), (at, aj)):
        assert not bool(a[dead].any()) and not bool(b[dead].any())
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= F32_TOL * scale
    jl = [torch.tensor(np.asarray(x)) for x in jax.tree.leaves(gj)]
    tl = jax.tree.leaves(gt, is_leaf=torch.is_tensor)
    assert [tuple(t.shape) for t in tl] == [tuple(x.shape) for x in jl]
    for i, (a, b) in enumerate(zip(tl, jl)):
        if i < 4:       # g_feat, g_dists, g_extras, g_w: rows of the groups
            assert not bool(_rows(a, dead, K).any())
            assert not bool(_rows(b, dead, K).any())
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) <= F32_TOL * scale


# the f32 kernels' layouts, mirrored in Python where the CPU can check them
def _spec(**kw):
    d = dict(Fi=32, Dd=6, E=7, Ff=3, Fd=5, H=256, K=8, L1=2, L3=2,
             neg_slope=0.01, bf16=False)
    d.update(kw)
    return fd.DecodeSpec(**d)


def test_f32_smem_formulas_at_scene_config():
    """scene_config()'s decode (x1 = 284, H = 256, 2 + 2 layers): inputs
    padded to 16 (288, 256, 272, 256) and to 4 (284, 256, 264, 256); K3 a
    transposed tile of 288 x 68 floats, a ring of 2 x 16 x 256 and three
    words per row, two CTAs to an SM; K4's phase A the tile, a 256 x 68 g_z
    tile, the z-sign bits and a ring of 3 x 8 x 256, phase B two stages of
    32 x (64 + 256)."""
    cfg = tcfg.scene_config(np.random.RandomState(0).rand(100, 3))
    spec = decode_spec(cfg.agg, cfg.query.K, bf16=False)
    assert spec == _spec()
    assert fd.f32_pads(spec) == ([288, 256, 272, 256], [284, 256, 264, 256])
    k3 = 4 * (288 * 68 + 2 * 16 * 256 + 3 * 64)
    assert fd.smem_bytes(spec) == k3 == 111872
    assert 2 * (k3 + 1024) <= 233472          # two CTAs on one SM
    a = 4 * ((288 + 256) * 68 + 4 * 64 * 8 + 3 * 8 * 256 + 3 * 64)
    assert fd.bwd_smem_bytes(spec) == (a, 4 * 2 * 32 * (64 + 256))


@pytest.mark.parametrize("kw", [{}, dict(H=128, L1=1, L3=1, E=0),
                                dict(Fi=4, Ff=0, Fd=0, Dd=3)])
def test_pack_f32_weights_round_trip(kw):
    """Both streams read every weight back, and their padding is zero."""
    spec = _spec(**kw)
    g = torch.Generator().manual_seed(0)
    ins = fd.layer_inputs(spec)
    Ws = [torch.randn((n, spec.H), generator=g) for n in ins]
    kp, kq = fd.f32_pads(spec)
    buf = fd.pack_f32_weights(Ws, spec, backward=True)
    assert buf.numel() == sum(kp) * spec.H + spec.H * sum(kq)
    assert torch.equal(fd.pack_f32_weights(Ws, spec),
                       buf[:sum(kp) * spec.H])
    off = 0
    for W, p in zip(Ws, kp):
        blk = buf[off:off + p * spec.H].view(p, spec.H)
        assert torch.equal(blk[:W.shape[0]], W) and not bool(
            blk[W.shape[0]:].any())
        off += p * spec.H
    for W, q in zip(Ws, kq):
        blk = buf[off:off + spec.H * q].view(spec.H, q)
        assert torch.equal(blk[:, :W.shape[0]], W.t()) and not bool(
            blk[:, W.shape[0]:].any())
        off += spec.H * q


def _first_kernels_take(spec, backward):
    """The envelope of the first f32 kernels: K3 two 64-row ping-pong
    buffers of max(x1, H + E) + 1 floats a row, K4 a 32-row tile holding
    every layer's input (padded to 4), the last hidden layer, the widest
    input gradient, the z-sign bits and two words a row."""
    if spec.H % 32 or spec.H > 256 or spec.L1 < 1 or spec.L3 < 1 \
            or spec.L1 + spec.L3 > 8 or 64 % spec.K:
        return False
    fwd = 2 * 64 * (max(spec.x1, spec.H + spec.E) + 1) * 4 <= 232448
    ins = [-(-n // 4) * 4 for n in fd.layer_inputs(spec)]
    bwd = 4 * (32 * (sum(ins) + spec.H + max(ins))
               + len(ins) * 32 * (spec.H // 32) + 64) <= 232448
    return fwd and (not backward or bwd)


@pytest.mark.parametrize("H", [32, 64, 128, 192, 256])
def test_f32_kernel_takes_every_spec_the_first_kernels_took(H):
    n = 0
    for L1 in range(1, 8):
        for L3 in range(1, 9 - L1):
            for E in (0, 7, 20):
                for Fi in range(1, 120, 3):
                    for K in (1, 8, 64):
                        for backward in (False, True):
                            spec = _spec(H=H, L1=L1, L3=L3, E=E, Fi=Fi,
                                         K=K, Ff=2, Fd=0, Dd=3)
                            if _first_kernels_take(spec, backward):
                                n += 1
                                assert fd.kernel_takes(spec, backward), spec
    assert n > 1000


@pytest.mark.parametrize("which", ["scene", "tiny", "bench", "cuda_tests"])
def test_f32_kernel_takes_the_named_configs(which):
    """scene_config(), tiny_test_config(), bench_config() in f32 and the
    specs of tests/test_torch_cuda.py, forward and backward."""
    if which == "cuda_tests":
        specs = [_spec(), _spec(H=128, L1=1, L3=1)]
    else:
        cfg = {"scene": lambda: tcfg.scene_config(np.zeros((10, 3))),
               "tiny": tcfg.tiny_test_config,
               "bench": tcfg.bench_config}[which]()
        specs = [decode_spec(cfg.agg, cfg.query.K, bf16=False)]
    for spec in specs:
        assert fd.kernel_takes(spec) and fd.kernel_takes(spec, backward=True)


def test_bwd_f32_cap_bounds_the_scratch():
    assert fd.bwd_f32_cap(1) == 64
    assert fd.bwd_f32_cap(2_304_000) == fd.F32_CAP_ROWS
    # scene_config's scratch per row: every padded layer input and g_z
    spec = _spec()
    row = 4 * (sum(fd.f32_pads(spec)[1]) + 4 * spec.H)
    assert row == 8336
    assert fd.F32_CAP_ROWS * row < 1.1e9
