"""The port's sharded fine pass, hybrid, neural2d step, multi-sequence
Waymo scenes and sharded per-scene loop against the JAX package's.

The port runs a world of two gloo ranks on the CPU (`multihost.World`,
started once for the file) at (dp 1, mp 2); JAX runs the same mesh on its
virtual CPU devices (tests/conftest.py), while the ranks work on the same
inputs (`World.submit`, then `World.results`). Mirrors of tests/test_sharded_fine,
test_sharded_hybrid and test_sharded_neural2d (deterministic evals, and a
train step that runs and learns), the Waymo bundles of
tests/test_waymo_export, and tests/test_parallel's probe-grow loop with
one prune, one probe-grow and an eval, whose checkpoint is read back.

Bars: integers equal; renders within 2e-4 of the largest magnitude
(ROADMAP.md's aggregator bar); the loop's per-step losses within the 1e-3
curve bar of tests/test_torch_train.py and its eval PSNR within 1e-2 dB,
as tests/test_torch_driver.py holds train_scene. JAX is imported only in
fixtures and test bodies: the ranks load this module for their jobs.
"""
import dataclasses
import functools
import re

import numpy as np
import pytest
import torch

from pointnerf_tpu_torch.parallel import multihost
from test_torch_parallel import (TOL, batch_arrays, close, cloud_shard,
                                 jax_batch, jax_np, params_tensors,
                                 port_batch, port_cfg, rank_mesh,
                                 synthetic_scene, to_np)

CURVE_BAR = 1e-3
EVAL_PSNR_BAR = 1e-2
PATCH = 16
C_FEAT = 16
HEAD_KW = dict(n_feat=16, input_dim=C_FEAT, img_size=32, min_feat=8)
LOOP_STEPS = 8
LOOP_WH = (32, 32)
# the probe frame in one chunk: the drivers' default chunk (9,216 rays)
# pads the 1,024-ray frame ninefold; prob-mode rays are independent, so the
# chunk changes no result
PROBE_CHUNK = LOOP_WH[0] * LOOP_WH[1]
EVENTS = re.compile(r"^\[(prune|grow)\] step (\d+): (kept |\+)(\d+)")


def base_cfg(**kw):
    """tests/test_parallel.sharded_cfg with `kw` replacing sections'
    fields: {"render": {...}, "query": {...}, ...}."""
    from pointnerf_tpu_torch.config import tiny_test_config
    cfg = tiny_test_config()
    cfg = cfg.replace(query=dataclasses.replace(cfg.query,
                                                shell_layered=False, P=128))
    return cfg.replace(**{sec: dataclasses.replace(getattr(cfg, sec), **f)
                          for sec, f in kw.items()}).to_json()


def fine_cfg(compact):
    return base_cfg(render=dict(fine_sample_num=8),
                    query=dict(decode_capacity=0.5 if compact else 0.0))


def hybrid_cfg(compact):
    return base_cfg(render=dict(nerf_importance=6, nerf_coarse_samples=12,
                                nerf_hidden=32, nerf_layers=2, nerf_pe_xyz=4,
                                nerf_pe_dir=2),
                    query=dict(decode_capacity=0.5 if compact else 0.0))


# ----------------------------------------------------------- rank jobs

def _state(cfg, sc, mesh, mlp=None):
    from pointnerf_tpu_torch.parallel import (build_sharded_scene,
                                              create_sharded_train_state)
    pc = cloud_shard(sc["pc"], mesh.m)
    scene = build_sharded_scene(pc, torch.tensor(sc["num_active"]), cfg,
                                mesh)
    return create_sharded_train_state(
        torch.Generator().manual_seed(9),
        params_tensors(sc["mlp"] if mlp is None else mlp), pc, scene, cfg,
        mesh)


def job_eval_and_learn(cfg_json, sc, mlp, learn_steps):
    """The sharded eval over the batch, then `learn_steps` train steps (the
    jitter drawn from the state's generator, the same on both ranks):
    the outputs, the losses, and the field's sigma weights before and
    after when there is a field."""
    from pointnerf_tpu_torch.parallel import (make_sharded_eval_step,
                                              make_sharded_train_step)
    mesh = rank_mesh(1, 2)
    cfg = port_cfg(cfg_json)
    state, scene = _state(cfg, sc, mesh, mlp)
    b = port_batch(sc["batch"])
    out = make_sharded_eval_step(cfg, mesh)(state.params, scene, b)
    res = {"out": {f: v.numpy() for f, v in out._asdict().items()
                   if v is not None}, "losses": []}
    nerf = state.params["mlp"].get("nerf")
    if nerf is not None:
        res["sigma_before"] = nerf["sigma"]["w"].numpy().copy()
    step = make_sharded_train_step(cfg, mesh)
    for _ in range(learn_steps):
        state, items = step(state, scene, b)
        res["losses"].append(float(items["loss_total"]))
    if nerf is not None:
        res["sigma_after"] = state.params["mlp"]["nerf"]["sigma"]["w"].numpy()
    return res


def job_n2d(cfg_json, sc, mlp, head_params, b, gt, steps):
    """`steps` sharded neural2d steps with the CNN head: each step's items
    and the first step's moments."""
    from pointnerf_tpu_torch.models.neural_render import NeuralRenderer
    from pointnerf_tpu_torch.parallel import (create_sharded_neural2d_state,
                                              make_sharded_neural2d_step)
    from pointnerf_tpu_torch.parallel import build_sharded_scene
    mesh = rank_mesh(1, 2)
    cfg = port_cfg(cfg_json)
    pc = cloud_shard(sc["pc"], mesh.m)
    scene = build_sharded_scene(pc, torch.tensor(sc["num_active"]), cfg,
                                mesh)
    head = NeuralRenderer(**HEAD_KW)
    state, scene = create_sharded_neural2d_state(
        torch.Generator(), params_tensors(mlp), pc, head_params, scene, cfg,
        mesh)
    step = make_sharded_neural2d_step(cfg, mesh, head, PATCH)
    res = {"items": []}
    for k in range(steps):
        state, items = step(state, scene, port_batch(b),
                            torch.tensor(gt)[None])
        res["items"].append({k: float(v) for k, v in items.items()})
        if k == 0:
            res["mu"] = to_np({g: state.opt_state[g].mu for g in state.params})
    return res


def job_loop(cfg_json, scene_pts, feats, conf, mlp, run_dir, probe_views):
    """The port's train_scene_sharded on the loop scene, with the given
    payloads and JAX's MLP weights in place of its seeded draw; then the
    checkpoint read back against the gathered state."""
    from pointnerf_tpu_torch.data.synthetic import ring_cameras, view_ray_batch
    from pointnerf_tpu_torch.parallel.sharded import gather_shards
    from pointnerf_tpu_torch.train import driver as td
    from pointnerf_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                      load_checkpoint)
    from pointnerf_tpu_torch.train.optim import tree_leaves
    mesh = rank_mesh(1, 2)
    cfg = port_cfg(cfg_json)
    real_init, real_probe = td.init_mlp_params, td.probe_hole_sharded
    td.init_mlp_params = (lambda g, c, device=None:
                          params_tensors(mlp))
    td.probe_hole_sharded = functools.partial(real_probe, chunk=PROBE_CHUNK)
    try:
        views = ring_cameras(n_views=4, wh=LOOP_WH, focal=40.0)

        def train_item(step):
            v = step % len(views)
            return view_ray_batch(*views[v], LOOP_WH, n_rays=64, seed=step,
                                  view_id=v)
        probe = [view_ray_batch(*views[i], LOOP_WH, view_id=i)
                 for i in probe_views]
        test = [view_ray_batch(*views[2], LOOP_WH, n_rays=64, seed=999)]
        state, scene, hist = td.train_scene_sharded(
            cfg, mesh, scene_pts, train_item, test, LOOP_WH,
            run_dir=run_dir, max_steps=LOOP_STEPS, probe_items=probe,
            features=feats, conf=conf)
    finally:
        td.init_mlp_params, td.probe_hole_sharded = real_init, real_probe
    full = gather_shards(state, mesh)
    loaded, meta = load_checkpoint(latest_checkpoint(run_dir), full)
    same = all(torch.equal(a, b) for a, b in
               zip(tree_leaves((loaded.params, loaded.opt_state,
                                loaded.step)),
                   tree_leaves((full.params, full.opt_state, full.step))))
    return dict(hist=hist, same=same, meta=meta,
                num_active=scene.num_active.numpy(),
                capacity=full.params["points"].xyz.shape)


# ------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def world():
    with multihost.World(2, "gloo", device="cpu") as w:
        yield w


@pytest.fixture(scope="module")
def scene_np():
    """The JAX tests' cloud (jax.random features), weights and rays,
    partitioned by JAX onto mp = 2, as numpy."""
    import jax
    from pointnerf_tpu.config import PointNeRFConfig
    from pointnerf_tpu.models.aggregator import init_aggregator_params
    from pointnerf_tpu.models.points import make_point_cloud
    from pointnerf_tpu.parallel import partition_points
    cfg = PointNeRFConfig.from_json(base_cfg())
    xyz, campos, camrot = synthetic_scene()
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    pc1, _ = make_point_cloud(xyz, k1, cfg.points,
                              cfg.agg.point_features_dim, capacity=512)
    n = xyz.shape[0]
    pc_s, num_active = partition_points(
        xyz, k1, cfg, mp=2, **{k: np.asarray(getattr(pc1, k)[:n])
                               for k in ("features", "color", "dirs",
                                         "conf")})
    return dict(pc=tuple(np.asarray(a) for a in pc_s),
                num_active=np.asarray(num_active),
                mlp=jax_np(init_aggregator_params(k2, cfg.agg)),
                batch=batch_arrays(campos, camrot), campos=campos,
                camrot=camrot)


def jax_eval(cfg_json, sc, mlp):
    import jax
    from pointnerf_tpu.config import PointNeRFConfig
    from pointnerf_tpu.models.points import PointCloud
    from pointnerf_tpu.parallel import (build_sharded_scene,
                                        create_sharded_train_state,
                                        make_mesh, make_sharded_eval_step)
    cfg = PointNeRFConfig.from_json(cfg_json)
    mesh = make_mesh(dp=1, mp=2)
    pc = PointCloud(*[jax.numpy.asarray(a) for a in sc["pc"]])
    scene = build_sharded_scene(pc, jax.numpy.asarray(sc["num_active"]), cfg,
                                mesh)
    state, scene = create_sharded_train_state(
        jax.random.PRNGKey(9), jax.tree.map(jax.numpy.asarray, mlp), pc,
        scene, cfg, mesh)
    out = make_sharded_eval_step(cfg, mesh)(state.params, scene,
                                            jax_batch(sc["batch"]))
    return {f: np.asarray(v) for f, v in out._asdict().items()
            if v is not None}


def hold_eval(res, jout, what):
    for rank, r in enumerate(res):
        assert sorted(r["out"]) == sorted(jout), (what, rank)
        for f, j in jout.items():
            if j.dtype == bool:
                np.testing.assert_array_equal(r["out"][f], j,
                                              err_msg=f"{what} {f}")
            else:
                close(r["out"][f], j, TOL, f"{what} rank {rank} {f}")
    assert jout["ray_mask"].sum() > 10


# ---------------------------------------------------------------- tests

@pytest.mark.parametrize("compact", [True, False])
def test_sharded_fine_matches_jax(world, scene_np, compact):
    """The fine pass on the mesh (each block resamples its own rays, the
    fine positions all-gathered over mp): the deterministic eval equals
    JAX's sharded one, fine_raycolor included; with the compacted decode
    the train step (fine loss on) learns over 4 steps."""
    cfg_json = fine_cfg(compact)
    if compact:
        cfg_json = port_cfg(cfg_json).replace(loss=dataclasses.replace(
            port_cfg(cfg_json).loss,
            color_loss_items=("ray_masked_coarse_raycolor", "fine_raycolor"),
            color_loss_weights=(1.0, 1.0))).to_json()
    world.submit(job_eval_and_learn, cfg_json, scene_np, None,
                 4 if compact else 0)
    jout = jax_eval(cfg_json, scene_np, scene_np["mlp"])
    assert "fine_raycolor" in jout
    res = world.results()
    hold_eval(res, jout, f"fine compact={compact}")
    if compact:
        losses = res[0]["losses"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
        assert res[1]["losses"] == losses


@pytest.mark.parametrize("compact", [True, False])
def test_sharded_hybrid_matches_jax(world, scene_np, compact):
    """The proposal-NeRF hybrid on the mesh (the field replicated, the
    merged march local to each block): the deterministic eval equals JAX's
    sharded one, the field's outputs included; two train steps update the
    field's weights."""
    import jax
    from pointnerf_tpu.config import PointNeRFConfig
    from pointnerf_tpu.models.nerf_branch import init_nerf_params
    cfg_json = hybrid_cfg(compact)
    mlp = dict(scene_np["mlp"], nerf=jax_np(init_nerf_params(
        jax.random.PRNGKey(5), PointNeRFConfig.from_json(cfg_json))))
    world.submit(job_eval_and_learn, cfg_json, scene_np, mlp,
                 2 if compact else 0)
    jout = jax_eval(cfg_json, scene_np, mlp)
    assert "nerf_coarse_raycolor" in jout
    res = world.results()
    hold_eval(res, jout, f"hybrid compact={compact}")
    if compact:
        r = res[0]
        assert np.isfinite(r["losses"]).all()
        assert not np.allclose(r["sigma_before"], r["sigma_after"])
        np.testing.assert_array_equal(r["sigma_after"],
                                      res[1]["sigma_after"])


def test_sharded_neural2d_matches_jax(world, scene_np):
    """The CNN head on the (dp 1, mp 2) mesh without jitter: three steps'
    losses (each after the previous updates: the all_gather transpose and
    the pmean normalization) and the first step's gradients of every group
    (its moments) against JAX's sharded neural2d step."""
    import jax
    from pointnerf_tpu.config import PointNeRFConfig
    from pointnerf_tpu.models import neural_render as jn
    from pointnerf_tpu.models.aggregator import init_aggregator_params
    from pointnerf_tpu.models.points import PointCloud
    from pointnerf_tpu.parallel import (build_sharded_scene,
                                        create_sharded_neural2d_state,
                                        make_mesh,
                                        make_sharded_neural2d_step)
    from pointnerf_tpu_torch.convert import neural_render_from_flax
    from pointnerf_tpu_torch.models import neural_render as tn
    from test_torch_neural_render import flax_fill
    sc = scene_np
    cfg_json = base_cfg(agg=dict(shading_color_channel_num=C_FEAT),
                        render=dict(train_jitter=0.0))
    cfg = PointNeRFConfig.from_json(cfg_json)
    mlp = jax_np(init_aggregator_params(jax.random.PRNGKey(1), cfg.agg))
    jhead = jn.NeuralRenderer(**HEAD_KW)
    hp = flax_fill(jhead, 1, np.zeros((1, PATCH, PATCH, C_FEAT)))
    rng = np.random.RandomState(0)
    x0, y0 = rng.randint(0, 64 - PATCH, 2)
    gx, gy = np.meshgrid(np.arange(x0, x0 + PATCH),
                         np.arange(y0, y0 + PATCH))
    from pointnerf_tpu_torch.camera import get_dtu_raydir
    pix = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    intr = np.array([[80.0, 0, 32.0], [0, 80.0, 32.0], [0, 0, 1]], np.float32)
    b = dict(campos=sc["campos"], camrotc2w=sc["camrot"],
             raydir=get_dtu_raydir(pix, intr, sc["camrot"],
                                   True).astype(np.float32),
             pixel_idx=pix.astype(np.int32),
             gt_image=np.zeros((PATCH * PATCH, 3), np.float32))
    gt = np.tile(np.array([0.2, 0.5, 0.8], np.float32), (PATCH, PATCH, 1))
    head_t = neural_render_from_flax(tn.NeuralRenderer(**HEAD_KW), hp, "cpu")
    world.submit(job_n2d, cfg_json, sc, mlp, head_t, b, gt, 3)

    mesh = make_mesh(dp=1, mp=2)
    pc = PointCloud(*[jax.numpy.asarray(a) for a in sc["pc"]])
    scene = build_sharded_scene(pc, jax.numpy.asarray(sc["num_active"]), cfg,
                                mesh)
    state, scene = create_sharded_neural2d_state(
        jax.random.PRNGKey(7), jax.tree.map(jax.numpy.asarray, mlp),
        pc, jax.tree.map(jax.numpy.asarray, hp), scene, cfg, mesh)
    step = make_sharded_neural2d_step(cfg, mesh, jhead, PATCH)
    jb = jax_batch(b)._replace(gt_image=None)
    jitems, jmu = [], None
    for k in range(3):
        state, items = step(state, scene, jb, jax.numpy.asarray(gt)[None])
        jitems.append({n: float(v) for n, v in items.items()})
        if k == 0:
            opt = state.opt_state
            jmu = {g: jax_np(opt.inner_states[g].inner_state[0].mu[g])
                   for g in ("mlp", "points", "head")}
    res = world.results()
    for rank, r in enumerate(res):
        for k in range(3):
            close(r["items"][k]["loss_total"], jitems[k]["loss_total"], TOL,
                  f"rank {rank} step {k} loss")
        for g in ("mlp", "points"):
            tl, jl = jax.tree.leaves(r["mu"][g]), jax.tree.leaves(jmu[g])
            assert len(tl) == len(jl)
            for a, j in zip(tl, jl):
                j = j[rank % 2] if g == "points" else j
                close(a, j, TOL, f"rank {rank} {g} grads")
        jh = neural_render_from_flax(tn.NeuralRenderer(**HEAD_KW),
                                     jmu["head"], "cpu")
        for name, v in jh.items():
            close(r["mu"]["head"][name], v.numpy(), TOL,
                  f"rank {rank} head grads {name}")


def test_load_multiseq_partitions_as_jax(tmp_path):
    """Two exported Waymo sequences: load_multiseq gives one dataset per
    sequence, item for item as JAX's; partition_points_multiseq puts one
    sequence on each of mp = 2 shards, every array but the drawn features
    bit for bit as JAX's."""
    import jax
    from pointnerf_tpu.config import DataConfig as JData
    from pointnerf_tpu.config import PointNeRFConfig
    from pointnerf_tpu.data.waymo import load_multiseq as j_multi
    from pointnerf_tpu.parallel.sharded import partition_points_multiseq as jp
    from pointnerf_tpu_torch.config import DataConfig as TData
    from pointnerf_tpu_torch.data.waymo import load_multiseq
    from pointnerf_tpu_torch.data.waymo_export import frames_to_npz
    from pointnerf_tpu_torch.parallel.sharded import (
        partition_points_multiseq)
    rng = np.random.RandomState(0)
    K = np.array([[50.0, 0, 30.0], [0, 50.0, 20.0], [0, 0, 1]], np.float32)
    for s in range(2):
        frames = []
        for i in range(6):
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, 3] = [0.3 * i, 0.0, 6.0 * s]
            pts = (rng.randn(300, 3).astype(np.float32) + [0, 0, 3 + 6.0 * s]
                   if i % 10 else None)
            frames.append({"image": rng.rand(40, 60, 3).astype(np.float32),
                           "c2w": c2w, "K": K, "points_world": pts})
        frames_to_npz(frames, str(tmp_path / f"seq{s}.npz"), vox_res=24,
                      device="cpu")
    kw = dict(dataset_name="waymo_ft", data_root=str(tmp_path), scan="seq0")
    ts = load_multiseq(TData(**kw), ["seq0", "seq1"])
    js = j_multi(JData(**kw), ["seq0", "seq1"])
    assert len(ts) == len(js) == 2
    clouds = []
    for dt, dj in zip(ts, js):
        assert dt.id_list == dj.id_list and len(dt) == len(dj) == 5
        a, b = dt.get_item(1, seed=1), dj.get_item(1, seed=1)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
        ca, cb = dt.load_init_points(), dj.load_init_points()
        np.testing.assert_array_equal(ca["xyz"], cb["xyz"])
        clouds.append(ca)
    cfg_json = base_cfg()
    tpc, tn, tseq = partition_points_multiseq(
        clouds, torch.Generator().manual_seed(0), port_cfg(cfg_json), 2,
        device="cpu")
    jpc, jn, jseq = jp(clouds, jax.random.PRNGKey(0),
                       PointNeRFConfig.from_json(cfg_json), 2)
    assert sorted(tseq.tolist()) == [0, 1]
    np.testing.assert_array_equal(tseq, jseq)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for f in ("xyz", "conf", "color", "dirs"):
        np.testing.assert_array_equal(getattr(tpc, f).numpy(),
                                      np.asarray(getattr(jpc, f)), err_msg=f)


def test_train_scene_sharded_matches_jax(world, tmp_path, capsys,
                                         monkeypatch):
    """tests/test_parallel's probe-grow loop at (dp 1, mp 2), no jitter,
    with JAX's MLP init and one payload set on both sides: a prune at step
    4 (a quarter of the points below prune_thresh), a probe-grow at 6 on a
    cloud with a cut (its missed rays grow points), an eval at 8. The
    events leave the same point counts, the losses follow JAX's and the
    PSNR agrees; rank 0's checkpoint of the gathered shards reads back bit
    for bit."""
    import jax
    import pointnerf_tpu.parallel as jpar
    import pointnerf_tpu.train.driver as jdrv
    from pointnerf_tpu.config import PointNeRFConfig
    from pointnerf_tpu.data.synthetic import (ring_cameras, sphere_scene,
                                              view_ray_batch)
    from pointnerf_tpu.parallel import make_mesh
    from pointnerf_tpu.train.driver import init_mlp_params, train_scene_sharded
    # P = 16 (no voxel of this cloud holds more): the probe frame is dense
    # prob-mode KNN, and at P = 128 JAX's bucket query spends most of the
    # test on it
    cfg_json = base_cfg(
        query=dict(P=16),
        render=dict(train_jitter=0.0),
        train=dict(maximum_step=LOOP_STEPS, prune_iter=4, prune_max_iter=4,
                   prune_thresh=0.1, prob_freq=6, prob_thresh=0.0,
                   prob_mul=0.4, test_freq=LOOP_STEPS, print_freq=1,
                   save_iter_freq=0))
    cfg = PointNeRFConfig.from_json(cfg_json)
    xyz, color, normals = sphere_scene(n_pts=800, radius=0.5)
    keep = xyz[:, 0] < 0.1
    pts = (xyz[keep], color[keep], normals[keep])
    n = pts[0].shape[0]
    rng = np.random.RandomState(1)
    feats = (rng.rand(n, cfg.agg.point_features_dim) * 0.01).astype(
        np.float32)
    conf = np.full((n, 1), 0.5, np.float32)
    conf[::4] = 0.05
    _k1, k2, _k3 = jax.random.split(jax.random.PRNGKey(cfg.train.seed), 3)
    mlp = jax_np(init_mlp_params(k2, cfg))
    real = jpar.partition_points
    monkeypatch.setattr(jpar, "partition_points",
                        lambda x, key, c, mp, **kw: real(
                            x, key, c, mp, features=feats, conf=conf, **kw))
    monkeypatch.setattr(jdrv, "probe_hole_sharded", functools.partial(
        jdrv.probe_hole_sharded, chunk=PROBE_CHUNK))
    probe_views = (1,)          # the view that looks into the cut
    views = ring_cameras(n_views=4, wh=LOOP_WH, focal=40.0)

    def train_item(step):
        v = step % len(views)
        return view_ray_batch(*views[v], LOOP_WH, n_rays=64, seed=step,
                              view_id=v)
    probe = [view_ray_batch(*views[i], LOOP_WH, view_id=i)
             for i in probe_views]
    test = [view_ray_batch(*views[2], LOOP_WH, n_rays=64, seed=999)]
    world.submit(job_loop, cfg_json, pts, feats, conf, mlp,
                 str(tmp_path / "port"), probe_views)
    capsys.readouterr()
    _js, jscene, jh = train_scene_sharded(
        cfg, make_mesh(dp=1, mp=2), pts, train_item, test, LOOP_WH,
        run_dir=str(tmp_path / "jax"), max_steps=LOOP_STEPS,
        probe_items=probe)
    events = [(k, int(s), int(v)) for k, s, _w, v in map(
        lambda m: m.groups(), filter(None, map(
            EVENTS.match, capsys.readouterr().out.splitlines())))]
    res = world.results()
    kept = events[0][2]
    assert events == [("prune", 4, kept), ("grow", 6, events[1][2])]
    assert kept == n - len(range(0, n, 4)) and events[1][2] > 0
    for r in res:
        h = r["hist"]
        assert h["prune"] == [(4, kept)]
        assert h["grow"] == [(6, events[1][2])]
        np.testing.assert_array_equal(r["num_active"],
                                      np.asarray(jscene.num_active))
        lt = [v for _s, v in h["loss"]]
        lj = [v for _s, v in jh["loss"]]
        assert len(lt) == len(lj) == LOOP_STEPS
        np.testing.assert_allclose(lt, lj, rtol=CURVE_BAR)
        assert abs(h["eval"][0]["psnr"] - jh["eval"][0]["psnr"]) \
            < EVAL_PSNR_BAR
        assert r["same"]
        assert r["meta"]["num_active"] == [int(v) for v in r["num_active"]]
        assert r["capacity"][0] == 2
