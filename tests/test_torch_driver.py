"""The port's per-scene driver and its I/O (pointnerf_tpu_torch/train/driver,
checkpoint, sampler; utils/metrics, visualizer) against the JAX package's.

- train_scene against JAX train_scene on the same scene, payloads, MLP
  weights (JAX's init converted) and rays, with one prune, one probe-hole
  grow and one split: every event leaves the same number of points, the
  grow candidates agree (count equal, values within the 2e-4 decode bar,
  after asserting the probe's argmax and threshold margins exceed the 1e-5
  march bar), the per-step losses follow JAX's within the 1e-3 curve bar of
  tests/test_torch_train.py and the eval PSNR within EVAL_PSNR_BAR dB;
- the checkpoint round trip is bit-exact (parameters, moments, counts, hit
  counters, step, generator state), and a CPU run of 2N steps equals N
  steps, a resume and N more, bit for bit, with jitter on;
- metrics and ErrorMapSampler equal JAX's (the same numpy code).

Config: tiny_test_config with the port's query (prebuilt tables, K1) and
kernel flags, f32; JAX Pallas kernels in interpret mode."""
import dataclasses
import os
import re
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.train import driver as jd
from pointnerf_tpu.train import grow as jg
from pointnerf_tpu_torch.convert import params_from_jax
from pointnerf_tpu_torch.data.synthetic import (ring_cameras, sphere_scene,
                                                view_ray_batch)
from pointnerf_tpu_torch.train import checkpoint as tck
from pointnerf_tpu_torch.train import driver as td
from pointnerf_tpu_torch.train import grow as tg
from test_torch_dense import MARCH_BAR, TOL, assert_argmax_margin
from test_torch_render import interpret_pallas  # noqa: F401

CURVE_BAR = 1e-3
EVAL_PSNR_BAR = 1e-2    # dB
WH = (24, 24)
FOCAL = 30.0
RADIUS = 0.9
TUNNEL = 0.82   # cos(35 degrees): the caps cut on the probe view's axis
STEPS = 12
EVENTS = re.compile(r"^\[(prune|grow|split)\] step (\d+): (.*)$")


def _cfg(jitter=0.0, **train):
    """tiny_test_config with prebuilt tables, K1 and the fused flags; a
    schedule with prunes at 4, 8 and 12, probes at 6 and 12, a split at 8
    and an eval at 12. prob_thresh is low because the weights are at their
    random init; it sits among the peak opacities of the first probe's
    candidate rays, so the threshold test keeps some and drops some."""
    cfg = td.demo_config(STEPS)
    t = dict(prune_iter=4, prune_max_iter=STEPS, prune_thresh=0.1,
             prob_freq=6, prob_thresh=0.016, prob_num_step=1, split_iter=8,
             split_top=8, test_freq=STEPS, print_freq=1, save_iter_freq=0,
             random_sample_size=8)
    t.update(train)
    return cfg.replace(
        render=dataclasses.replace(cfg.render, train_jitter=jitter),
        train=dataclasses.replace(cfg.train, **t))


def _scene(n_pts=800):
    """An n_pts-point sphere of radius RADIUS with a tunnel on the probe
    view's axis (the caps within 35 degrees of it cut on both sides: rays
    down the tunnel miss while the ground truth is the sphere), a quarter
    of the points below prune_thresh, and four views: training batches
    from all, the probe frame from view 0, the test frame from view 2."""
    xyz, color, normals = sphere_scene(n_pts=n_pts, radius=RADIUS, seed=0)
    views = ring_cameras(n_views=4, wh=WH, focal=FOCAL)
    axis = views[0][0] / np.linalg.norm(views[0][0])
    keep = np.abs(normals @ axis) < TUNNEL
    xyz, color, normals = xyz[keep], color[keep], normals[keep]
    n = xyz.shape[0]
    rng = np.random.RandomState(1)
    features = (rng.rand(n, 8) * 0.01).astype(np.float32)
    conf = np.full((n, 1), 0.5, np.float32)
    conf[::4] = 0.05
    probe = [view_ray_batch(*views[0], WH, radius=RADIUS, view_id=0)]
    test = [view_ray_batch(*views[2], WH, radius=RADIUS, view_id=2)]

    def train_item(step):
        v = step % len(views)
        return view_ray_batch(*views[v], WH, n_rays=64, seed=step,
                              radius=RADIUS, view_id=v)
    return (xyz, color, normals), features, conf, train_item, probe, test


def _events(out: str):
    return [m.groups() for m in map(EVENTS.match, out.splitlines()) if m]


def test_train_scene_matches_jax(interpret_pallas, tmp_path, capsys,
                                 monkeypatch):
    cfg = _cfg()
    pts, features, conf, train_item, probe, test = _scene()
    # JAX draws the MLP weights from PRNGKey(seed); the port takes the
    # same ones
    _k1, k2, _k3 = jax.random.split(jax.random.PRNGKey(cfg.train.seed), 3)
    jparams = jax.tree.map(np.asarray, jd.init_mlp_params(k2, cfg))
    monkeypatch.setattr(td, "init_mlp_params", lambda _g, _c, device=None:
                        params_from_jax(jparams, device=device))
    # record both probes' candidates, and check the margins on JAX's maps
    cands = {"jax": [], "port": []}
    stash, tested = [], []
    real_eval = jg.eval_step

    def eval_rec(*a, **k):
        out = real_eval(*a, **k)
        if k.get("prob"):
            stash.append(np.asarray(out.coarse_point_opacity))
        return out
    monkeypatch.setattr(jg, "eval_step", eval_rec)
    real_acc = jg.accumulate_probe_candidates

    def acc_rec(adds, maps, item, c, wh, bg):
        W, H = wh
        hit = maps["ray_mask"][..., 0] > 0
        gt = np.asarray(item["gt_image"]).reshape(H, W, 3)
        miss = ~hit & (np.linalg.norm(gt - bg, axis=-1) > 0.002)
        near_hole = hit & jg._dilate3(miss)
        op = stash[-1][:W * H].reshape(H, W, -1)
        assert_argmax_margin(op[near_hole])
        max_op = maps["ray_max_shading_opacity"][near_hole, 0]
        if max_op.size:
            assert np.abs(max_op - c.train.prob_thresh).min() > MARCH_BAR
        tested.append((max_op.size, int((max_op > c.train.prob_thresh).sum())))
        return real_acc(adds, maps, item, c, wh, bg)
    monkeypatch.setattr(jg, "accumulate_probe_candidates", acc_rec)
    for name, mod in (("jax", jg), ("port", tg)):
        real = mod.probe_hole

        def rec(*a, _real=real, _name=name, **k):
            cands[_name].append(_real(*a, **k))
            return cands[_name][-1]
        monkeypatch.setattr(mod, "probe_hole", rec)
    monkeypatch.setattr(jd, "probe_hole", jg.probe_hole)
    monkeypatch.setattr(td, "probe_hole", tg.probe_hole)

    jax_cfg = _jax_cfg(cfg)
    _js, _jst, jh = jd.train_scene(jax_cfg, pts, train_item, test, probe, WH,
                                   run_dir=str(tmp_path / "jax"),
                                   features=features, conf=conf)
    j_events = _events(capsys.readouterr().out)
    _ts, _tst, th = td.train_scene(cfg, pts, train_item, test, probe, WH,
                                   run_dir=str(tmp_path / "port"),
                                   features=features, conf=conf,
                                   device="cpu")
    t_events = _events(capsys.readouterr().out)

    assert [e[0] for e in t_events] == ["prune", "grow", "prune", "split",
                                        "prune", "grow"]
    assert t_events == j_events
    kept = int(re.match(r"kept (\d+)", t_events[0][2]).group(1))
    assert kept < pts[0].shape[0]
    # the first probe's threshold kept some candidate rays and dropped some
    added = int(re.match(r"\+(\d+)", t_events[1][2]).group(1))
    assert 0 < tested[0][1] == added < tested[0][0]
    assert len(cands["port"]) == len(cands["jax"]) == 2
    for cp, cj in zip(cands["port"], cands["jax"]):
        for f in cj._fields:
            a, b = getattr(cp, f), getattr(cj, f)
            assert a.shape == b.shape, f
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=f)
    lj = [v for _s, v in jh["loss"]]
    lt = [v for _s, v in th["loss"]]
    assert len(lt) == len(lj) == STEPS
    np.testing.assert_allclose(lt, lj, rtol=CURVE_BAR)
    assert len(th["eval"]) == len(jh["eval"]) == 1
    assert abs(th["eval"][0]["psnr"] - jh["eval"][0]["psnr"]) < EVAL_PSNR_BAR
    assert np.isfinite(th["eval"][0]["ssim"])


def _jax_cfg(cfg):
    from pointnerf_tpu.config import PointNeRFConfig
    return PointNeRFConfig.from_json(cfg.to_json())


def _state_leaves(state):
    from pointnerf_tpu_torch.train.optim import tree_leaves
    return tree_leaves([state.params, state.opt_state, state.step,
                        state.hits])


def _assert_bits_equal(a, b):
    la, lb = _state_leaves(a), _state_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.uint8) if x.dim() else x,
                           y.view(torch.uint8) if y.dim() else y)
    assert torch.equal(a.key.get_state(), b.key.get_state())


def _small_state(cfg):
    from pointnerf_tpu_torch.models.points import make_point_cloud
    from pointnerf_tpu_torch.train.step import create_train_state
    xyz, color, normals = sphere_scene(n_pts=300, seed=2)
    pc, st = make_point_cloud(xyz, torch.Generator().manual_seed(0),
                              cfg.points, cfg.agg.point_features_dim,
                              color=color, dirs=normals, device="cpu")
    params = td.init_mlp_params(torch.Generator().manual_seed(1), cfg,
                                device="cpu")
    return create_train_state(torch.Generator().manual_seed(2), params, pc,
                              cfg), st


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    from pointnerf_tpu_torch.models.renderer import ray_batch_from_numpy
    from pointnerf_tpu_torch.train.step import refresh_grid, train_step
    cfg = _cfg(jitter=0.3, hit_lr_boost=2.0)
    state, st = _small_state(cfg)
    grid, _ = refresh_grid(state.params["points"], st, cfg)
    views = ring_cameras(n_views=2, wh=WH, focal=float(WH[0]))
    for i in range(2):
        item = view_ray_batch(*views[i], WH, n_rays=64, seed=i)
        state, _ = train_step(state, st, grid,
                              ray_batch_from_numpy(item, cfg, "cpu"), cfg)
    assert float(state.hits.abs().sum()) > 0
    path = tck.save_checkpoint(str(tmp_path), state, {"num_active": 300,
                                                      "capacity": 4096})
    assert path.endswith("ckpt_00000002")
    assert tck.latest_checkpoint(str(tmp_path)) == path
    assert tck.checkpoint_meta(path) == {"step": 2, "num_active": 300,
                                         "capacity": 4096}
    template, _ = _small_state(cfg)
    loaded, meta = tck.load_checkpoint(path, template)
    assert meta["num_active"] == 300
    _assert_bits_equal(loaded, state)
    # the next jitter draw is the same
    assert torch.equal(torch.rand(4, generator=loaded.key),
                       torch.rand(4, generator=state.key))

    # a checkpoint written without hit counters restores with zero ones
    flat = torch.load(os.path.join(path, tck.STATE_FILE), weights_only=True)
    del flat["hits"]
    torch.save(flat, os.path.join(path, tck.STATE_FILE))
    legacy, _ = tck.load_checkpoint(path, _small_state(cfg)[0])
    assert float(legacy.hits.abs().sum()) == 0
    assert torch.equal(legacy.params["mlp"]["alpha"][0]["w"],
                       state.params["mlp"]["alpha"][0]["w"])
    # a template of another capacity is refused, naming the entry
    from pointnerf_tpu_torch.train.grow import pad_point_opt_state
    big = template._replace(params=dict(
        template.params, points=type(template.params["points"])(
            *[torch.cat([t, t]) for t in template.params["points"]])),
        opt_state=pad_point_opt_state(template.opt_state, 4096, 8192))
    with pytest.raises(ValueError, match="params/points/xyz"):
        tck.load_checkpoint(path, big)


def test_resume_equals_a_straight_run(tmp_path, capsys):
    """2N steps in one run and N + resume + N give the same bits, with
    jitter on and prune, grow (re-bucketing into a larger capacity), split
    and a checkpoint inside each half."""
    cfg = _cfg(jitter=0.3, prune_iter=2, prob_freq=3, split_iter=4,
               test_freq=0, prune_max_iter=8, prob_thresh=0.0,
               split_top=4000)
    pts, features, conf, train_item, probe, test = _scene(n_pts=4000)
    runs = {}
    for name, splits in (("straight", (8,)), ("resumed", (4, 8))):
        for i, n in enumerate(splits):
            state, st, hist = td.train_scene(
                cfg, pts, train_item, test, probe, WH,
                run_dir=str(tmp_path / name), max_steps=n, resume=i > 0,
                features=features, conf=conf, device="cpu")
        runs[name] = (state, st, hist)
    out = capsys.readouterr().out
    assert "resumed from" in out
    (sa, sta, ha), (sb, stb, hb) = runs["straight"], runs["resumed"]
    assert int(sa.step) == int(sb.step) == 8
    assert int(sta.num_active) == int(stb.num_active)
    assert sa.params["points"].capacity > 4096     # grew past one bucket
    _assert_bits_equal(sb, sa)
    assert [v for _s, v in ha["loss"][4:]] == [v for _s, v in hb["loss"]]


def test_train_scene_needs_the_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts, features, conf, train_item, probe, test = _scene()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.train_scene(_cfg(), pts, train_item, test, probe, WH,
                       run_dir=str(tmp_path))


def test_metrics_match_jax():
    from pointnerf_tpu.utils import metrics as jm
    from pointnerf_tpu_torch.utils import metrics as tm
    rng = np.random.RandomState(0)
    a, b = rng.rand(2, 20, 23, 3).astype(np.float32)
    for f in ("psnr", "rmse", "ssim", "lpips_proxy"):
        assert getattr(tm, f)(a, b) == getattr(jm, f)(a, b), f
    assert tm.psnr(a, a) == jm.psnr(a, a) == 99.0
    assert tm.report_metrics([a, b], [b, a]) == jm.report_metrics([a, b],
                                                                  [b, a])
    assert tm.lpips_fn("alex") is jm.lpips_fn("alex") is None


def test_error_map_sampler_matches_jax():
    from pointnerf_tpu.train.sampler import ErrorMapSampler as JS
    from pointnerf_tpu_torch.train.sampler import ErrorMapSampler as TS
    js, ts = JS(3, (20, 14), cell=4), TS(3, (20, 14), cell=4)
    for step in range(70):       # crosses the 64-step backstop flush
        view = step % 3
        pix = js.sample_pixels(view, 50, np.random.RandomState(step))
        np.testing.assert_array_equal(
            pix, ts.sample_pixels(view, 50, np.random.RandomState(step)))
        err = np.random.RandomState(100 + step).rand(50).astype(np.float32)
        js.record(view, pix, jnp.asarray(err))
        ts.record(view, pix, torch.from_numpy(err))
        if step % 20 == 19:
            js.flush()
            ts.flush()
    js.flush()
    ts.flush()
    np.testing.assert_array_equal(ts.maps, js.maps)
    ts.record(None, pix, torch.zeros(50))
    assert not ts._pending
    with pytest.raises(ValueError):
        TS(1, (4, 4), cell=0)


def _read_png(path):
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = hdr[:4]
    assert depth == 8 and ctype == 2
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def test_visualizer_matches_jax(tmp_path, capsys):
    from pointnerf_tpu.utils.visualizer import Visualizer as JV, to8b
    from pointnerf_tpu_torch.utils.visualizer import Visualizer as TV
    img = np.random.RandomState(0).rand(7, 9, 3).astype(np.float32) * 1.2
    jv, tv = JV(str(tmp_path / "j")), TV(str(tmp_path / "t"))
    p = tv.save_image(img, "a.png")
    np.testing.assert_array_equal(_read_png(p), to8b(img))
    import imageio.v2 as imageio
    np.testing.assert_array_equal(_read_png(p),
                                  imageio.imread(jv.save_image(img, "a.png")))
    xyz = np.random.RandomState(1).rand(5, 3).astype(np.float32)
    for v in (jv, tv):
        v.save_neural_points("pts", xyz, color=xyz)
        v.save_options('{"a": 1}')
        for i in range(3):
            v.accumulate_losses({"loss_total": torch.tensor(float(i))
                                 if v is tv else jnp.asarray(float(i)),
                                 "psnr": float(i)})
    mj, mt = jv.print_losses(3), tv.print_losses(3)
    assert mt == mj == {"loss_total": 1.0, "psnr": 1.0}
    for f in ("points/pts.txt", "opt.json"):
        with open(tmp_path / "t" / f) as a, open(tmp_path / "j" / f) as b:
            assert a.read() == b.read()


def test_profiling_on_the_cpu(tmp_path):
    """utils/profiling: StepTimer reports as JAX's does (mean_ms, total_s,
    count per section); device_trace writes a Chrome trace that names the
    annotated range and the ops run inside it."""
    import json as _json
    import time as _time
    from pointnerf_tpu.utils.profiling import StepTimer as JTimer
    from pointnerf_tpu_torch.utils.profiling import (StepTimer, annotate,
                                                     device_trace)
    timer, jtimer = StepTimer(torch.device("cpu")), JTimer()
    for t in (timer, jtimer):
        for _ in range(3):
            with t.section("a"):
                _time.sleep(0.002)
        t.time_fn("b", lambda: torch.ones(3) * 2)
    rep, jrep = timer.report(), jtimer.report()
    assert {k: set(v) for k, v in rep.items()} == \
        {k: set(v) for k, v in jrep.items()}
    assert rep["a"]["count"] == 3 and rep["b"]["count"] == 1
    assert rep["a"]["mean_ms"] >= 2.0
    assert abs(rep["a"]["total_s"] * 1000 / 3 - rep["a"]["mean_ms"]) < 1e-9
    with device_trace(str(tmp_path), name="t") as prof:
        with annotate("my_section"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.get("name") for e in _json.load(
        open(tmp_path / "t.pt.trace.json"))["traceEvents"]}
    assert "my_section" in names and "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())
