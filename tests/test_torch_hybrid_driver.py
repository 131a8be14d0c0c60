"""The port's per-scene driver with the proposal-NeRF hybrid and NeRF-driven
point creation (pointnerf_tpu_torch/train/driver.train_scene,
grow.probe_hole with nerf_create_points, checkpoint) against the JAX
package's train_scene.

- train_scene on the tunnel sphere of tests/test_torch_driver.py with the
  hybrid (a small field) and nerf_create_points, over 12 steps with one
  probe: the probe creates points on missed rays (count equal to JAX's,
  after asserting every field mass lies more than the march bar from
  prob_thresh), the per-step losses follow JAX's within the 1e-3 curve bar
  and the eval PSNR within EVAL_PSNR_BAR dB. JAX's training draws are
  injected into the port's steps (jax_draws of tests/test_torch_hybrid.py
  on the key chain of JAX's train_scene);
- a checkpoint with params["nerf"] round-trips bit for bit;
- 2N steps equal N steps, a resume and N more, bit for bit (CPU, the
  draws from the state's generator).

Config: test_torch_driver's tiny config (prebuilt tables, K1, the fused
flags), f32; JAX Pallas kernels in interpret mode."""
import dataclasses
import re

import jax
import numpy as np
import torch

from pointnerf_tpu.train import driver as jd
from pointnerf_tpu.train import grow as jg
from pointnerf_tpu_torch.convert import params_from_jax
from pointnerf_tpu_torch.data.synthetic import ring_cameras, view_ray_batch
from pointnerf_tpu_torch.train import checkpoint as tck
from pointnerf_tpu_torch.train import driver as td
from pointnerf_tpu_torch.train import grow as tg
from test_torch_dense import MARCH_BAR
from test_torch_driver import (CURVE_BAR, EVAL_PSNR_BAR, STEPS, WH,
                               _assert_bits_equal, _cfg, _events, _jax_cfg,
                               _scene, _small_state)
from test_torch_hybrid import jax_draws
from test_torch_render import interpret_pallas  # noqa: F401


def _hcfg(**train):
    """test_torch_driver's config with the hybrid on (4 field samples from
    16 coarse ones, a 32-wide two-layer field whose color also supervises
    the field) and nerf_create_points; one probe at step 6, no prune or
    split, an eval at 12."""
    t = dict(nerf_create_points=True, prune_iter=0, split_iter=0,
             prob_freq=6, prob_thresh=0.05)
    t.update(train)
    cfg = _cfg(**t)
    return cfg.replace(
        render=dataclasses.replace(
            cfg.render, nerf_importance=4, nerf_coarse_samples=16,
            nerf_hidden=32, nerf_layers=2, nerf_pe_xyz=4, nerf_pe_dir=2),
        loss=dataclasses.replace(
            cfg.loss,
            color_loss_items=tuple(cfg.loss.color_loss_items)
            + ("nerf_coarse_raycolor",),
            color_loss_weights=tuple(cfg.loss.color_loss_weights) + (0.5,)))


def test_hybrid_train_scene_matches_jax(interpret_pallas, tmp_path, capsys,
                                        monkeypatch):
    cfg = _hcfg()
    pts, features, conf, train_item, probe, test = _scene()
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(cfg.train.seed), 3)
    jparams = jax.tree.map(np.asarray, jd.init_mlp_params(k2, cfg))
    assert "nerf" in jparams
    monkeypatch.setattr(td, "init_mlp_params", lambda _g, _c, device=None:
                        params_from_jax(jparams, device=device))
    # the port's steps take JAX's draws: JAX's state key starts at k3 and
    # each step splits off its render key
    keys = [k3]
    real_step = td.train_step

    def step_with_jax_draws(state, st, grid, batch, c, **kw):
        keys[0], sub = jax.random.split(keys[0])
        _u, draws = jax_draws(sub, c, batch.raydir.shape[0])
        return real_step(state, st, grid, batch, c, draws=draws)
    monkeypatch.setattr(td, "train_step", step_with_jax_draws)
    # record both probes' candidates and the field masses JAX's probe read
    cands, masses = {"jax": [], "port": []}, []
    real_acc = jg.accumulate_probe_candidates

    def acc_rec(adds, maps, item, c, wh, bg):
        masses.append(maps["nerf_mass"][..., 0].ravel())
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

    _js, jst, jh = jd.train_scene(_jax_cfg(cfg), pts, train_item, test, probe,
                                  WH, run_dir=str(tmp_path / "jax"),
                                  features=features, conf=conf)
    j_events = _events(capsys.readouterr().out)
    _ts, tst, th = td.train_scene(cfg, pts, train_item, test, probe, WH,
                                  run_dir=str(tmp_path / "port"),
                                  features=features, conf=conf, device="cpu")
    t_events = _events(capsys.readouterr().out)
    assert len(masses) == 2 and len(cands["jax"]) == len(cands["port"]) == 2
    # no field mass within the march bar of the threshold
    m = np.concatenate(masses)
    assert np.abs(m - cfg.train.prob_thresh).min() > MARCH_BAR
    assert [e[0] for e in t_events] == ["grow", "grow"]
    assert t_events == j_events
    added = int(re.match(r"\+(\d+)", t_events[0][2]).group(1))
    created = [int((mm > cfg.train.prob_thresh).sum()) for mm in masses]
    assert added > 0 and created[0] > 0
    assert int(tst.num_active) == int(jst.num_active) > pts[0].shape[0]
    for cp, cj in zip(cands["port"], cands["jax"]):
        assert cp.xyz.shape == cj.xyz.shape
        np.testing.assert_array_equal(cp.embedding, cj.embedding)
        for f in ("xyz", "color", "dirs", "conf"):
            np.testing.assert_allclose(getattr(cp, f), getattr(cj, f),
                                       rtol=2e-4, atol=2e-4, err_msg=f)
    lj = [v for _s, v in jh["loss"]]
    lt = [v for _s, v in th["loss"]]
    assert len(lt) == len(lj) == STEPS
    np.testing.assert_allclose(lt, lj, rtol=CURVE_BAR)
    assert len(th["eval"]) == len(jh["eval"]) == 1
    assert abs(th["eval"][0]["psnr"] - jh["eval"][0]["psnr"]) < EVAL_PSNR_BAR


def test_hybrid_checkpoint_round_trip_is_bit_exact(tmp_path):
    from pointnerf_tpu_torch.models.renderer import ray_batch_from_numpy
    from pointnerf_tpu_torch.train.step import refresh_grid, train_step
    cfg = _hcfg()
    state, st = _small_state(cfg)
    assert set(state.params["mlp"]["nerf"]) == {"trunk", "sigma", "rgb1",
                                                "rgb2"}
    grid, _ = refresh_grid(state.params["points"], st, cfg)
    views = ring_cameras(n_views=2, wh=WH, focal=float(WH[0]))
    before = state.params["mlp"]["nerf"]["trunk"][0]["w"].clone()
    for i in range(2):
        item = view_ray_batch(*views[i], WH, n_rays=64, seed=i)
        state, _ = train_step(state, st, grid,
                              ray_batch_from_numpy(item, cfg, "cpu"), cfg)
    # the field trains in the "mlp" group
    assert not torch.equal(state.params["mlp"]["nerf"]["trunk"][0]["w"],
                           before)
    assert float(state.opt_state["mlp"].nu["nerf"]["rgb2"]["w"].abs().sum()) > 0
    path = tck.save_checkpoint(str(tmp_path), state, {"num_active": 300,
                                                      "capacity": 4096})
    loaded, _meta = tck.load_checkpoint(path, _small_state(cfg)[0])
    _assert_bits_equal(loaded, state)
    flat = torch.load(path + "/" + tck.STATE_FILE, weights_only=True)
    assert "params/mlp/nerf/trunk/1/w" in flat
    assert "opt_state/mlp/mu/nerf/sigma/b" in flat


def test_hybrid_resume_equals_a_straight_run(tmp_path, capsys):
    """2N steps in one run and N + resume + N give the same bits with the
    hybrid's draws from the state's generator, and NeRF-driven creation and
    a checkpoint inside each half."""
    cfg = _hcfg(prob_freq=3, test_freq=0, prob_thresh=0.02)
    pts, features, conf, train_item, probe, test = _scene()
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
    assert int(sta.num_active) == int(stb.num_active) > pts[0].shape[0]
    _assert_bits_equal(sb, sa)
    assert [v for _s, v in ha["loss"][4:]] == [v for _s, v in hb["loss"]]
