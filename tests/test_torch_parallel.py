"""The port's sharded path (pointnerf_tpu_torch/parallel) against the JAX
package's (pointnerf_tpu/parallel) on the CPU.

JAX runs its shard_map programs on the virtual 8-device CPU mesh that
tests/conftest.py sets up; the port runs a real world of four gloo ranks
(`multihost.World`, started once for the file, one torch thread a rank),
each holding its own point shard. The config is tests/test_parallel.py's
sharded_cfg: tiny_test_config with shell_layered=False and P=128.

Bars: integers (masks, slots, bucket and table ids, counts) equal; the
partition, the grids, and prune/grow from the same state bit for bit;
rendered and trained floats within 2e-4 of the largest magnitude (the
aggregator's bar, ROADMAP.md), sample positions within 1e-5.

JAX is imported only inside fixtures and helpers the test process calls:
the ranks import this module to find their jobs, and they load torch and
the port alone.
"""
import dataclasses

import numpy as np
import pytest
import torch

from pointnerf_tpu_torch.parallel import multihost

TOL = 2e-4
POS_TOL = 1e-5
WORLD = 4
N_PTS = 400
R = 64


# ---------------------------------------------------------------- helpers

def synthetic_scene(seed=0, n_pts=N_PTS):
    """tests/test_render.synthetic_scene: a ball of points in front of a
    camera at -z."""
    rng = np.random.RandomState(seed)
    xyz = np.clip(rng.normal(0, 0.25, (n_pts, 3)).astype(np.float32),
                  -0.9, 0.9)
    return (xyz, np.array([0.0, 0.0, -3.0], np.float32),
            np.eye(3, dtype=np.float32))


def batch_arrays(campos, camrot, n=R, seed=1):
    """tests/test_render.make_batch's rays as numpy arrays."""
    from pointnerf_tpu_torch.camera import get_dtu_raydir
    rng = np.random.RandomState(seed)
    intr = np.array([[80.0, 0, 32.0], [0, 80.0, 32.0], [0, 0, 1]], np.float32)
    pix = rng.randint(0, 64, (n, 2)).astype(np.float32)
    raydir = get_dtu_raydir(pix, intr, camrot, True).astype(np.float32)
    gt = np.tile(np.array([[0.2, 0.5, 0.8]], np.float32), (n, 1))
    return dict(campos=campos, camrotc2w=camrot, raydir=raydir,
                pixel_idx=pix.astype(np.int32), gt_image=gt)


def port_batch(b, device="cpu"):
    from pointnerf_tpu_torch.models.renderer import RayBatch

    def t(a):
        return torch.tensor(a, device=device)
    return RayBatch(campos=t(b["campos"]), camrotc2w=t(b["camrotc2w"]),
                    raydir=t(b["raydir"]), pixel_idx=t(b["pixel_idx"]),
                    near=t(2.0), far=t(4.5), gt_image=t(b["gt_image"]))


def jax_batch(b):
    import jax.numpy as jnp
    from pointnerf_tpu.models.renderer import RayBatch
    return RayBatch(campos=jnp.asarray(b["campos"]),
                    camrotc2w=jnp.asarray(b["camrotc2w"]),
                    raydir=jnp.asarray(b["raydir"]),
                    pixel_idx=jnp.asarray(b["pixel_idx"]),
                    near=jnp.asarray(2.0), far=jnp.asarray(4.5),
                    gt_image=jnp.asarray(b["gt_image"]))


def sharded_cfg_json(**query):
    """tests/test_parallel.sharded_cfg (JSON, read by both packages)."""
    from pointnerf_tpu_torch.config import tiny_test_config
    cfg = tiny_test_config()
    return cfg.replace(query=dataclasses.replace(
        cfg.query, shell_layered=False, P=128, **query)).to_json()


def rank_mesh(dp, mp, device="cpu"):
    """A rank's mesh (None past dp * mp), one torch thread."""
    from pointnerf_tpu_torch.parallel import make_mesh
    torch.set_num_threads(1)
    return make_mesh(dp, mp, device=device)


def port_cfg(cfg_json):
    from pointnerf_tpu_torch.config import PointNeRFConfig
    return PointNeRFConfig.from_json(cfg_json)


def cloud_shard(pc_np, m, device="cpu"):
    """Shard m of a [mp, cap, ...] cloud of numpy arrays."""
    from pointnerf_tpu_torch.models.points import PointCloud
    return PointCloud(*[torch.tensor(a[m], device=device) for a in pc_np])


def params_tensors(tree, device="cpu"):
    from pointnerf_tpu_torch.convert import params_from_jax
    return params_from_jax(tree, device)


def to_np(tree):
    from pointnerf_tpu_torch.train.optim import tree_map
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


def close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-12)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def jax_np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


# ----------------------------------------------------------- rank jobs

SCENE_FIELDS = ("num_active", "vox_slot", "bucket_pnt", "bucket_cnt",
                "bucket_xyz", "occ_union", "vox_dslot", "nbr_xyz", "nbr_pid",
                "occ_vids")


def job_build(cfg_json, pc_np, num_active, dp, mp):
    """Each rank builds its shard's grids: the scene's arrays."""
    from pointnerf_tpu_torch.parallel import build_sharded_scene
    mesh = rank_mesh(dp, mp)
    if mesh is None:
        return None
    scene = build_sharded_scene(cloud_shard(pc_np, mesh.m),
                                torch.tensor(num_active), port_cfg(cfg_json),
                                mesh)
    return {f: (None if getattr(scene, f) is None
                else getattr(scene, f).numpy()) for f in SCENE_FIELDS}


def job_eval(cfg_json, pc_np, num_active, mlp_np, b, dp, mp, prob,
             device="cpu"):
    """The sharded eval step over the whole batch, on every rank; on a card
    also the kernel launches it made ("launches")."""
    from pointnerf_tpu_torch.ops.fused_decode import fused_decode
    from pointnerf_tpu_torch.ops.fused_march import fused_march
    from pointnerf_tpu_torch.ops.knn_select import knn_select
    from pointnerf_tpu_torch.parallel import (build_sharded_scene,
                                              create_sharded_train_state,
                                              make_sharded_eval_step)
    mesh = rank_mesh(dp, mp, device)
    if mesh is None:
        return None
    dev = mesh.device
    cfg = port_cfg(cfg_json)
    pc = cloud_shard(pc_np, mesh.m, dev)
    scene = build_sharded_scene(pc, torch.tensor(num_active, device=dev),
                                cfg, mesh)
    state, scene = create_sharded_train_state(
        torch.Generator(device=dev), params_tensors(mlp_np, dev), pc, scene,
        cfg, mesh)
    kernels = (knn_select, fused_decode, fused_march)
    before = [k.launches for k in kernels]
    out = make_sharded_eval_step(cfg, mesh, prob=prob)(
        state.params, scene, port_batch(b, dev))
    res = {f: v.cpu().numpy() for f, v in out._asdict().items()
           if v is not None}
    if dev.type == "cuda":
        res["launches"] = [k.launches - n for k, n in zip(kernels, before)]
    return res


def job_collectives(dp, mp, device):
    """all_to_all and all_gather over mp (forward, and backward with a
    seeded cotangent), psum and pmax over the mesh, on one rank's seeded
    tensors on `device`."""
    import torch.distributed as dist
    from pointnerf_tpu_torch.parallel import make_mesh
    from pointnerf_tpu_torch.parallel.collectives import (all_gather,
                                                          all_to_all, pmax,
                                                          pmean, psum)
    torch.set_num_threads(1)
    mesh = make_mesh(dp, mp, device=device)
    if mesh is None:
        return None
    r, dev = dist.get_rank(), mesh.device

    def draw(seed, shape):
        return torch.randn(shape, generator=torch.Generator().manual_seed(
            seed)).to(dev)
    x = draw(r, (4, 3, 2, 5)).requires_grad_()
    y = all_to_all(x, mesh)
    ct = draw(100 + r, tuple(y.shape))
    (gx,) = torch.autograd.grad(y, x, ct)
    z = all_gather(x, mesh, "mp", 0)
    ctz = draw(200 + r, tuple(z.shape))
    (gz,) = torch.autograd.grad(z, x, ctz)
    out = dict(x=x, y=y, ct=ct, gx=gx, z=z, ctz=ctz, gz=gz,
               s=psum(x, mesh, ("dp", "mp")), mx=pmax(x, mesh, "dp"),
               pm=pmean(x, mesh, "mp"),
               b=all_gather(x[:, 0, 0, 0] > 0, mesh, ("dp", "mp"), 0))
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def hold_collectives(res, dp, mp):
    """The jobs' results against their numpy definitions (JAX's tiled
    all_to_all / all_gather and their transposes)."""
    K, n = 2, 4 // mp
    for rank, r in enumerate(res):
        d, m = divmod(rank, mp)
        row = [res[d * mp + j] for j in range(mp)]
        y = np.concatenate([q["x"][m * n:(m + 1) * n] for q in row], axis=2)
        np.testing.assert_array_equal(r["y"], y)
        gx = np.concatenate([q["ct"][:, :, m * K:(m + 1) * K] for q in row])
        np.testing.assert_array_equal(r["gx"], gx)
        np.testing.assert_array_equal(r["z"], np.concatenate(
            [q["x"] for q in row]))
        np.testing.assert_allclose(r["gz"], sum(
            q["ctz"][m * 4:(m + 1) * 4] for q in row), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["s"], sum(q["x"] for q in res),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(r["mx"], np.max(
            [res[e * mp + m]["x"] for e in range(dp)], axis=0))
        np.testing.assert_allclose(r["pm"], sum(q["x"] for q in row) / mp,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(r["b"], np.concatenate(
            [q["x"][:, 0, 0, 0] > 0 for q in res]))


def job_rank_sum(x):
    """x + rank, summed over the world (an all_reduce)."""
    import torch.distributed as dist
    t = torch.tensor([float(x + dist.get_rank())])
    dist.all_reduce(t)
    return float(t)


def job_past_envelope(cfg_json, xyz, feats, mlp_np, b):
    """A two-shard scene whose first shard's dilated cells exceed the
    config's max_d: each rank's grid count, the table size the build
    settles on, and the sharded request against the single-device one (the
    whole cloud, refresh_grid auto-sizing its tables too)."""
    from pointnerf_tpu_torch.models.points import make_point_cloud
    from pointnerf_tpu_torch.ops.grid import build_grid
    from pointnerf_tpu_torch.parallel import (build_sharded_scene,
                                              create_sharded_train_state,
                                              make_sharded_eval_step,
                                              partition_points)
    from pointnerf_tpu_torch.train.step import eval_step, refresh_grid
    mesh = rank_mesh(1, 2)
    if mesh is None:
        return None
    cfg = port_cfg(cfg_json)
    pc, num_active = partition_points(xyz, None, cfg, 2, features=feats,
                                      shard=mesh.m, device="cpu")
    own = int(build_grid(pc.xyz, num_active[mesh.m], cfg.query).num_dil)
    scene = build_sharded_scene(pc, num_active, cfg, mesh)
    mlp = params_tensors(mlp_np)
    state, scene = create_sharded_train_state(torch.Generator(), mlp, pc,
                                              scene, cfg, mesh)
    out = make_sharded_eval_step(cfg, mesh)(state.params, scene,
                                            port_batch(b))
    pc1, st1 = make_point_cloud(xyz, None, cfg.points,
                                cfg.agg.point_features_dim, features=feats,
                                device="cpu")
    grid1, max_d1 = refresh_grid(pc1, st1, cfg)
    ref = eval_step({"mlp": mlp, "points": pc1}, st1, grid1, port_batch(b),
                    cfg)
    return dict(own=own, max_d=scene.max_d, table_rows=scene.nbr_pid.shape[0],
                max_d1=max_d1, out={f: getattr(out, f).numpy() for f in
                                    ("ray_mask", "coarse_raycolor",
                                     "coarse_point_opacity")},
                ref={f: getattr(ref, f).numpy() for f in
                     ("ray_mask", "coarse_raycolor", "coarse_point_opacity")})


def _grads_from_moments(new, old, g):
    """The gradient of one Adam step: (mu' - b1 mu) / (1 - b1)."""
    from pointnerf_tpu_torch.train.optim import B1, tree_map
    return tree_map(lambda a, b: (a - B1 * b) / (1 - B1),
                    new[g].mu, old[g].mu)


def job_train(cfg_json, pc_np, num_active, mlp_np, b, us, dp, mp, warm):
    """Sharded train steps from a fresh state with JAX's jitter draws `us`
    (one step each), then prune and grow from JAX's warm state `warm` (its leaves in
    the port's layout, [mp, cap, ...] for the points). Returns each step's
    items, gradients (from the moments), moments and parameters; the
    pruned and grown states, scene counts and the MLP bits of every step."""
    from pointnerf_tpu_torch.parallel import (build_sharded_scene,
                                              create_sharded_train_state,
                                              make_sharded_train_step)
    from pointnerf_tpu_torch.parallel.sharded import (sharded_grow,
                                                      sharded_prune)
    from pointnerf_tpu_torch.train.grow import ProbeCandidates
    from pointnerf_tpu_torch.train.optim import tree_map
    from pointnerf_tpu_torch.train.step import TrainState
    mesh = rank_mesh(dp, mp)
    if mesh is None:
        return None
    cfg = port_cfg(cfg_json)
    pc = cloud_shard(pc_np, mesh.m)
    scene = build_sharded_scene(pc, torch.tensor(num_active), cfg, mesh)
    state, scene = create_sharded_train_state(
        torch.Generator(), params_tensors(mlp_np), pc, scene, cfg, mesh)
    step = make_sharded_train_step(cfg, mesh)
    res = {"steps": []}
    for u in us:
        new, items = step(state, scene, port_batch(b), u=torch.tensor(u))
        res["steps"].append({
            "items": {k: float(v) for k, v in items.items()},
            "grads": to_np({g: _grads_from_moments(new.opt_state,
                                                   state.opt_state, g)
                            for g in ("mlp", "points")}),
            "mu": to_np({g: new.opt_state[g].mu for g in ("mlp", "points")}),
            "nu": to_np({g: new.opt_state[g].nu for g in ("mlp", "points")}),
            "params": to_np(new.params)})
        state = new
    # prune and grow from JAX's warm state, the shard of this rank
    shard = tree_map(lambda a: torch.tensor(a[mesh.m]),
                     warm["params"]["points"])
    op = warm["opt"]["points"]
    opt = {"mlp": tree_map(torch.tensor, warm["opt"]["mlp"]),
           "points": op._replace(
               count=torch.tensor(op.count),
               mu=tree_map(lambda a: torch.tensor(a[mesh.m]), op.mu),
               nu=tree_map(lambda a: torch.tensor(a[mesh.m]), op.nu))}
    wstate = TrainState(params={"mlp": params_tensors(warm["params"]["mlp"]),
                                "points": shard},
                        opt_state=opt,
                        step=torch.tensor(warm["step"], dtype=torch.int32),
                        key=torch.Generator())
    wscene = build_sharded_scene(shard, torch.tensor(warm["num_active"]),
                                 cfg, mesh)
    pstate, pscene, kept = sharded_prune(wstate, wscene, cfg, mesh)
    cand = ProbeCandidates(**warm["cand"])
    gstate, gscene, added = sharded_grow(pstate, pscene, cand, cfg, mesh)
    res.update(kept=kept, added=added,
               prune_active=pscene.num_active.numpy(),
               grow_active=gscene.num_active.numpy(),
               prune_points=to_np(pstate.params["points"]),
               prune_mu=to_np(pstate.opt_state["points"].mu),
               prune_nu=to_np(pstate.opt_state["points"].nu),
               grow_points=to_np(gstate.params["points"]),
               grow_mu=to_np(gstate.opt_state["points"].mu),
               grow_nu=to_np(gstate.opt_state["points"].nu),
               grow_vox_slot=gscene.vox_slot.numpy(),
               grow_bucket_cnt=gscene.bucket_cnt.numpy())
    return res


# ------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def world():
    with multihost.World(WORLD, "gloo", device="cpu") as w:
        yield w


@pytest.fixture(scope="module")
def scene_np():
    """The JAX test's cloud, features and weights (jax.random), partitioned
    onto mp = 2 by JAX, as numpy."""
    import jax
    from pointnerf_tpu.config import PointNeRFConfig
    from pointnerf_tpu.models.aggregator import init_aggregator_params
    from pointnerf_tpu.models.points import make_point_cloud
    from pointnerf_tpu.parallel import partition_points
    cfg = PointNeRFConfig.from_json(sharded_cfg_json())
    xyz, campos, camrot = synthetic_scene()
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    pc1, _st1 = make_point_cloud(xyz, k1, cfg.points,
                                 cfg.agg.point_features_dim, capacity=512)
    payload = {k: np.asarray(getattr(pc1, k)[:N_PTS])
               for k in ("features", "color", "dirs", "conf")}
    pc_s, num_active = partition_points(xyz, k1, cfg, mp=2, **payload)
    return dict(xyz=xyz, payload=payload, pc=tuple(np.asarray(a)
                                                   for a in pc_s),
                num_active=np.asarray(num_active),
                mlp=jax_np(init_aggregator_params(k2, cfg.agg)),
                batch=batch_arrays(campos, camrot))


def jax_sharded(cfg_json, sc, dp, mp):
    """JAX's mesh, scene and state for the scene."""
    import jax
    from pointnerf_tpu.config import PointNeRFConfig
    from pointnerf_tpu.models.points import PointCloud
    from pointnerf_tpu.parallel import (build_sharded_scene,
                                        create_sharded_train_state,
                                        make_mesh)
    cfg = PointNeRFConfig.from_json(cfg_json)
    mesh = make_mesh(dp=dp, mp=mp)
    pc = PointCloud(*[jax.numpy.asarray(a) for a in sc["pc"]])
    num_active = jax.numpy.asarray(sc["num_active"])
    scene = build_sharded_scene(pc, num_active, cfg, mesh)
    state, scene = create_sharded_train_state(
        jax.random.PRNGKey(3), jax.tree.map(jax.numpy.asarray, sc["mlp"]),
        pc, scene, cfg, mesh)
    return cfg, mesh, scene, state


# ---------------------------------------------------------------- tests

@pytest.mark.parametrize("dp,mp", [(2, 2), (1, 4)])
def test_collectives_forward_and_backward(world, dp, mp):
    """A real gloo world: the tiled all_to_all over mp and its reverse as
    backward, the tiled all_gather and its transpose (cotangents summed
    over mp, each rank's own block), psum / pmean / pmax over the mesh's
    axes, and a bool gathered over the mesh in rank order."""
    hold_collectives(world.run(job_collectives, dp, mp, "cpu"), dp, mp)


def test_partition_points_matches_jax(scene_np):
    """Round-robin shards, every payload bit for bit, with and without a
    fixed capacity; `shard` picks one shard alone."""
    from pointnerf_tpu_torch.parallel import partition_points
    sc = scene_np
    cfg = port_cfg(sharded_cfg_json())
    pc, num_active = partition_points(sc["xyz"], None, cfg, 2,
                                      **sc["payload"], device="cpu")
    np.testing.assert_array_equal(num_active.numpy(), sc["num_active"])
    for a, b in zip(pc, sc["pc"]):
        np.testing.assert_array_equal(a.numpy(), b)
    one, _ = partition_points(sc["xyz"], None, cfg, 2, **sc["payload"],
                              shard=1, capacity_per_shard=8192,
                              device="cpu")
    assert one.capacity == 8192
    np.testing.assert_array_equal(one.xyz.numpy()[:4096], sc["pc"][0][1])


def _multiseq_clouds():
    rng = np.random.RandomState(3)

    def cloud(n, **kw):
        c = {"xyz": rng.rand(n, 3).astype(np.float32)}
        for k, w in kw.items():
            c[k] = rng.rand(n, w).astype(np.float32)
        return c
    return [cloud(300, feature=8, conf=1), cloud(120, color=3),
            cloud(200, feature=8, dirs=3)]


@pytest.mark.parametrize("mp", [2, 4])
def test_partition_points_multiseq_matches_jax(mp):
    """Sequences onto the point axis, both branches: mp < n_seq (mixed
    shards, whose missing payloads JAX fills from RandomState(1000 + s))
    and mp >= n_seq (shards allotted by point count). Every payload bit for
    bit, except a shard's features that no part of it has (each package
    draws them from its own generator)."""
    import jax
    from pointnerf_tpu.config import PointNeRFConfig
    from pointnerf_tpu.parallel.sharded import partition_points_multiseq as jp
    from pointnerf_tpu_torch.parallel.sharded import (
        partition_points_multiseq as tp)
    clouds = _multiseq_clouds()
    cfg_json = sharded_cfg_json()
    jpc, jn, jseq = jp(clouds, jax.random.PRNGKey(0),
                       PointNeRFConfig.from_json(cfg_json), mp)
    tpc, tn, tseq = tp(clouds, torch.Generator().manual_seed(0),
                       port_cfg(cfg_json), mp, device="cpu")
    np.testing.assert_array_equal(tseq, jseq)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for f in tpc._fields:
        a, b = getattr(tpc, f).numpy(), np.asarray(getattr(jpc, f))
        for s in range(mp):
            parts = ([j for j in range(3) if j % mp == s] if mp < 3
                     else [int(jseq[s])])
            if f == "features" and all("feature" not in clouds[j]
                                       for j in parts):
                continue
            np.testing.assert_array_equal(a[s], b[s], err_msg=f"{f} {s}")


# the prebuilt tables at 1,024 rows: each shard has ~680 dilated cells, and
# the default (4 max_o = 16,384 rows of 27 x 128 candidates) would spend
# most of the file's time building empty rows
TABLES = dict(prebuild_neighbors=True, max_d=1024)


@pytest.mark.parametrize("prebuilt", [False, True])
def test_build_sharded_scene_matches_jax(world, scene_np, prebuilt):
    """Each rank's grids, tables, union occupancy and union cell list equal
    JAX's row of its [mp, ...] scene."""
    import jax
    from pointnerf_tpu.config import PointNeRFConfig
    from pointnerf_tpu.models.points import PointCloud
    from pointnerf_tpu.parallel import build_sharded_scene, make_mesh
    sc = scene_np
    cfg_json = sharded_cfg_json(**(TABLES if prebuilt else {}))
    jscene = build_sharded_scene(
        PointCloud(*[jax.numpy.asarray(a) for a in sc["pc"]]),
        jax.numpy.asarray(sc["num_active"]),
        PointNeRFConfig.from_json(cfg_json), make_mesh(dp=2, mp=2))
    res = world.run(job_build, cfg_json, sc["pc"], sc["num_active"], 2, 2)
    for rank, r in enumerate(res):
        m = rank % 2
        for f in SCENE_FIELDS:
            j = getattr(jscene, f)
            if j is None:
                assert r[f] is None, f
                continue
            j = np.asarray(j)
            if f in ("vox_slot", "bucket_pnt", "bucket_cnt", "bucket_xyz",
                     "vox_dslot", "nbr_xyz", "nbr_pid"):
                j = j[m]
            np.testing.assert_array_equal(r[f], j,
                                          err_msg=f"rank {rank} {f}")


EVAL_CASES = {"dense": (dict(), False),
              "compact_tables": (dict(decode_capacity=0.5, **TABLES), False),
              "prob_tables": (TABLES, True)}


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_sharded_eval_matches_jax(world, scene_np, case):
    """The eval step at (dp 2, mp 2) — dense on bucket rows, compacted on
    prebuilt tables, and the probe outputs (prob=True) — every output JAX
    returns, on every rank, in JAX's (dp, mp) ray order."""
    from pointnerf_tpu.parallel import make_sharded_eval_step
    sc = scene_np
    query, prob = EVAL_CASES[case]
    cfg_json = sharded_cfg_json(**query)
    cfg, mesh, jscene, jstate = jax_sharded(cfg_json, sc, 2, 2)
    jout = make_sharded_eval_step(cfg, mesh, prob=prob)(
        jstate.params, jscene, jax_batch(sc["batch"]))
    res = world.run(job_eval, cfg_json, sc["pc"], sc["num_active"],
                    sc["mlp"], sc["batch"], 2, 2, prob)
    jfields = {f: np.asarray(v) for f, v in jout._asdict().items()
               if v is not None}
    assert jfields["ray_mask"].sum() > 10
    for rank, r in enumerate(res):
        assert sorted(r) == sorted(jfields), rank
        for f, j in jfields.items():
            what = f"rank {rank} {case} {f}"
            if j.dtype == bool:
                np.testing.assert_array_equal(r[f], j, err_msg=what)
            else:
                close(r[f], j, POS_TOL if "loc_w" in f else TOL, what)


@pytest.fixture(scope="module")
def jax_train(scene_np):
    """JAX's sharded train step at (dp 2, mp 2) on the compacted decode
    (half the points of each shard below prune_thresh), its jitter draw,
    and prune and grow from the state after the step, with enough
    candidates to re-bucket every shard."""
    import jax
    from pointnerf_tpu.parallel import make_sharded_train_step
    from pointnerf_tpu.parallel.sharded import sharded_grow, sharded_prune
    from pointnerf_tpu.train.grow import ProbeCandidates
    sc = dict(scene_np)
    conf = sc["pc"][2].copy()
    conf[:, :100, 0] = 0.01
    sc["pc"] = sc["pc"][:2] + (conf,) + sc["pc"][3:]
    cfg_json = sharded_cfg_json(decode_capacity=0.5)
    cfg, mesh, jscene, state = jax_sharded(cfg_json, sc, 2, 2)
    step = make_sharded_train_step(cfg, mesh)
    jb = jax_batch(sc["batch"])
    us, steps = [], []
    for _ in range(1):
        _key, sub = jax.random.split(state.key)
        k_coarse, _k_fine = jax.random.split(sub)
        us.append(np.asarray(jax.random.uniform(
            k_coarse, (R // 2, cfg.query.z_depth_dim))))
        old = jax_np(state)
        state, items = step(state, jscene, jb)
        new = jax_np(state)
        steps.append(dict(old=old, new=new,
                          items={k: float(v) for k, v in items.items()}))
    rng = np.random.RandomState(7)
    F = cfg.agg.point_features_dim
    n_cand = 8000            # past 4096 - 100 per shard: every shard grows
    cand = dict(xyz=rng.uniform(-0.5, 0.5, (n_cand, 3)).astype(np.float32),
                embedding=rng.rand(n_cand, F).astype(np.float32),
                color=rng.rand(n_cand, 3).astype(np.float32),
                dirs=rng.rand(n_cand, 3).astype(np.float32),
                conf=rng.rand(n_cand, 1).astype(np.float32))
    warm_np = steps[-1]["new"]
    pstate, pscene, kept = sharded_prune(state, jscene, cfg, mesh)
    pruned = jax_np((pstate, pscene))
    gstate, gscene, added = sharded_grow(pstate, pscene,
                                         ProbeCandidates(**cand), cfg, mesh)
    return dict(sc=sc, cfg_json=cfg_json, us=us, steps=steps, cand=cand,
                warm=warm_np, jscene_active=np.asarray(jscene.num_active),
                kept=kept, added=added, pruned=pruned,
                grown=jax_np((gstate, gscene)))


def _port_opt_layout(opt_state, group):
    """JAX's Adam state of one group, as the port's AdamState."""
    from pointnerf_tpu_torch.train.optim import AdamState
    inner = opt_state.inner_states[group].inner_state[0]
    return AdamState(count=np.int32(inner.count), mu=inner.mu[group],
                     nu=inner.nu[group])


def _jax_moments(state, group):
    inner = state.opt_state.inner_states[group].inner_state[0]
    return inner.mu[group], inner.nu[group]


def _as_leaves(tree):
    import jax
    return jax.tree.leaves(tree)


@pytest.fixture(scope="module")
def port_train(world, jax_train):
    from pointnerf_tpu_torch.models.points import PointCloud
    jt = jax_train
    warm = jt["warm"]
    pts = warm.params["points"]
    opt_mlp = _port_opt_layout(warm.opt_state, "mlp")
    opt_pts = _port_opt_layout(warm.opt_state, "points")
    warm_port = dict(
        params={"mlp": warm.params["mlp"],
                "points": PointCloud(*[np.asarray(a) for a in pts])},
        opt={"mlp": opt_mlp,
             "points": opt_pts._replace(
                 mu=PointCloud(*[np.asarray(a) for a in opt_pts.mu]),
                 nu=PointCloud(*[np.asarray(a) for a in opt_pts.nu]))},
        step=int(warm.step), num_active=jt["jscene_active"], cand=jt["cand"])
    return world.run(job_train, jt["cfg_json"], jt["sc"]["pc"],
                     jt["sc"]["num_active"], jt["sc"]["mlp"],
                     jt["sc"]["batch"], jt["us"], 2, 2, warm_port)


def test_sharded_train_step_matches_jax(jax_train, port_train):
    """One step at (dp 2, mp 2) with JAX's jitter draw: the loss and the
    items, the MLP and point gradients (each rank's shard against JAX's row
    of it), the moments, and the parameters where JAX's gradient is not at
    rounding level (Adam turns any gradient into a step of +-lr). The MLP
    parameters are the same bits on every rank after the step."""
    import jax
    from pointnerf_tpu_torch.train.optim import B1
    jt = jax_train
    for i, js in enumerate(jt["steps"]):
        jg = {g: jax.tree.map(lambda a, b: (a - B1 * b) / (1 - B1),
                              _jax_moments(js["new"], g)[0],
                              _jax_moments(js["old"], g)[0])
              for g in ("mlp", "points")}
        for rank, r in enumerate(port_train):
            m = rank % 2
            ps = r["steps"][i]
            for k in ("loss_total", "psnr", "n_decode_dropped"):
                close(ps["items"][k], js["items"][k], TOL,
                      f"step {i} rank {rank} {k}")
            for g in ("mlp", "points"):
                jm, jn = _jax_moments(js["new"], g)
                tl = _as_leaves(ps["grads"][g])
                for name, tt, jj in (("grad", tl, _as_leaves(jg[g])),
                                     ("mu", _as_leaves(ps["mu"][g]),
                                      _as_leaves(jm)),
                                     ("nu", _as_leaves(ps["nu"][g]),
                                      _as_leaves(jn))):
                    assert len(tt) == len(jj)
                    for a, b in zip(tt, jj):
                        b = np.asarray(b)[m] if g == "points" else b
                        close(a, b, TOL, f"step {i} rank {rank} {g} {name}")
            gl = _as_leaves(jg["mlp"]) + [np.asarray(x)[m] for x in
                                           _as_leaves(jg["points"])]
            pl = (_as_leaves(ps["params"]["mlp"])
                  + _as_leaves(ps["params"]["points"]))
            jl = (_as_leaves(js["new"].params["mlp"])
                  + [np.asarray(x)[m] for x in
                     _as_leaves(js["new"].params["points"])])
            for g, a, b in zip(gl, pl, jl):
                sel = np.abs(np.asarray(g)) > 1e-6
                np.testing.assert_allclose(a[sel], np.asarray(b)[sel],
                                           rtol=TOL, atol=1e-6)
        first = _as_leaves(port_train[0]["steps"][i]["params"]["mlp"])
        for r in port_train[1:]:
            for a, b in zip(first, _as_leaves(r["steps"][i]["params"]["mlp"])):
                np.testing.assert_array_equal(a, b)


def test_sharded_prune_grow_matches_jax(jax_train, port_train):
    """From JAX's state after the step: prune packs each shard's
    survivors and carries the Adam moments through the permutation (dead
    tail zeroed); grow deals 8,000 candidates round-robin, re-buckets every
    shard to one larger capacity and starts grown slots at zero moments.
    Counts, clouds, moments and the rebuilt grids equal JAX's bit for bit."""
    jt = jax_train
    (jp, jps), (jg, jgs) = jt["pruned"], jt["grown"]
    assert jt["kept"] == 200 and jt["added"] == 8000
    for rank, r in enumerate(port_train):
        m = rank % 2
        assert r["kept"] == jt["kept"] and r["added"] == jt["added"]
        np.testing.assert_array_equal(r["prune_active"], jps.num_active)
        np.testing.assert_array_equal(r["grow_active"], jgs.num_active)
        for tag, pts, jpts, jopt in (("prune", r["prune_points"],
                                      jp.params["points"], jp.opt_state),
                                     ("grow", r["grow_points"],
                                      jg.params["points"], jg.opt_state)):
            mu, nu = _jax_moments(jg if tag == "grow" else jp, "points")
            for f in pts._fields:
                np.testing.assert_array_equal(
                    getattr(pts, f), np.asarray(getattr(jpts, f))[m],
                    err_msg=f"rank {rank} {tag} {f}")
                np.testing.assert_array_equal(
                    getattr(r[f"{tag}_mu"], f), np.asarray(getattr(mu, f))[m],
                    err_msg=f"rank {rank} {tag} mu {f}")
                np.testing.assert_array_equal(
                    getattr(r[f"{tag}_nu"], f), np.asarray(getattr(nu, f))[m],
                    err_msg=f"rank {rank} {tag} nu {f}")
        assert r["grow_points"].xyz.shape[0] == 8192
        np.testing.assert_array_equal(r["grow_vox_slot"], jgs.vox_slot[m])
        np.testing.assert_array_equal(r["grow_bucket_cnt"],
                                      jgs.bucket_cnt[m])


def test_multihost_helpers_single_process(monkeypatch):
    """One process: initialize() does nothing, a rank's slice is the whole
    batch, a 1 x 1 mesh needs no process group, and global_ray_batch gives
    the rank's arrays as tensors on its device."""
    from pointnerf_tpu_torch.parallel import make_mesh
    for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE", "SLURM_JOB_ID"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() is False
    s = multihost.host_batch_slice(3600)
    assert (s.start, s.stop) == (0, 3600)
    mesh = make_mesh(1, 1, device="cpu")
    assert (mesh.d, mesh.m, mesh.size) == (0, 0, 1)
    assert multihost.host_batch_slice(3600, mesh) == slice(0, 3600)
    arrs = multihost.global_ray_batch(mesh, {"x": np.ones((3600, 3))})
    assert arrs["x"].shape == (3600, 3) and arrs["x"].device.type == "cpu"
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    assert multihost.initialize() is False
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(2, 1, device="cpu")


def test_world_submit_then_results(world):
    """`submit` starts a job on every rank and returns at once, `results`
    waits for it; a job nobody waited for is drained by the next submit,
    and `results` with nothing submitted raises."""
    want = WORLD * 10 + sum(range(WORLD))
    world.submit(job_rank_sum, 10)
    assert world.results() == [want] * WORLD
    world.submit(job_rank_sum, 10)
    world.submit(job_rank_sum, 20)
    assert world.results() == [want + WORLD * 10] * WORLD
    with pytest.raises(RuntimeError, match="no job was submitted"):
        world.results()
    assert world.run(job_rank_sum, 0) == [sum(range(WORLD))] * WORLD


def test_sharded_tables_past_the_envelope_rebuild(world):
    """The port's one difference from JAX's sharded build, on purpose: a
    shard whose dilated-occupied cells exceed max_d (here the first, its
    points spread over the box, the second's packed in a ball) makes every
    rank rebuild with max_d auto-sized from the largest shard's count, as
    refresh_grid does on one device (JAX's sharded build truncates the
    tables silently). The sharded request then equals the single-device
    one, whose refresh_grid auto-sizes its tables too."""
    rng = np.random.RandomState(4)
    n = 400
    xyz = np.empty((n, 3), np.float32)
    xyz[0::2] = rng.uniform(-0.8, 0.8, (n // 2, 3))          # shard 0
    xyz[1::2] = np.clip(rng.normal(0, 0.05, (n // 2, 3)), -0.9, 0.9)
    feats = (rng.rand(n, 8) * 0.01).astype(np.float32)
    cfg_json = sharded_cfg_json(prebuild_neighbors=True, max_d=512)
    from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
    mlp = to_np(init_aggregator_params(port_cfg(cfg_json).agg,
                                       torch.Generator().manual_seed(1),
                                       device="cpu"))
    _xyz, campos, camrot = synthetic_scene()
    res = world.run(job_past_envelope, cfg_json, xyz, feats, mlp,
                    batch_arrays(campos, camrot))
    r0, r1 = res[0], res[1]
    assert r0["own"] > 512 >= r1["own"]
    want = -(-int(r0["own"] * 1.25) // 4096) * 4096
    for r in res[:2]:
        assert r["max_d"] == r["table_rows"] == want
        assert r["max_d1"] >= 4096
        np.testing.assert_array_equal(r["out"]["ray_mask"],
                                      r["ref"]["ray_mask"])
        assert r["ref"]["ray_mask"].sum() > 10
        for f in ("coarse_raycolor", "coarse_point_opacity"):
            close(r["out"][f], r["ref"][f], TOL, f)
