"""Per-scene optimization driver.

Counterpart of `pointnerf_tpu/train/driver.py`: `ItemPrefetcher`,
`init_mlp_params`, `evaluate`, `train_scene`, `mvs_init_cloud`,
`train_dataset_scene`, `test_dataset_scene`, `render_video`,
`render_video_from_checkpoint`, `demo`, `ff_demo`,
`train_feedforward_dataset`, `n2d_demo` and `main` (`--demo`,
`--dataset`, `--test`, `--video`, `--ff-demo`, `--ff-dataset`,
`--n2d-demo`).
One process, no restart loop: prune and grow change the cloud in place
(`train/grow.py`) and the Adam state is carried through. The schedule:

- every `prune_iter` steps in (0, prune_max_iter]: confidence prune;
- every `prob_freq` steps: probe-hole growth over the probe frames whose
  training batches missed the most rays;
- every `split_iter` steps in (0, prune_max_iter]: gradient split;
- every `test_freq` steps: full-frame eval with PSNR/SSIM;
- every `save_iter_freq` steps, and at the end: a checkpoint.

The grid is rebuilt after every change of the point set, with the table
size (max_d) that the previous build settled on. Everything runs on one
device, `cuda` unless the caller asks for the CPU.

    python -m pointnerf_tpu_torch.train.driver --demo [--device cpu]
    python -m pointnerf_tpu_torch.train.driver --dataset nerf_synth360_ft \
        --data-root DIR --scan NAME [--test | --video] [--device cpu]

(`--dataset` also takes tt_ft / nsvf — an NSVF scene directory —,
waymo_ft — a `<scan>.npz` bundle of `data/waymo_export.frames_to_npz` — and
dtu / dtu_ft, a DTU-layout directory whose cloud MVSNet builds:
`mvs_init_cloud`.) Feed-forward (generalization) training, MVSNet and the
aggregator end to end:

    python -m pointnerf_tpu_torch.train.driver --ff-demo [--device cpu]
    python -m pointnerf_tpu_torch.train.driver --ff-dataset \
        --data-root DIR --scan NAME [--steps N] [--device cpu]

Feature rendering decoded by the 2D CNN head (`train/neural2d.py`):

    python -m pointnerf_tpu_torch.train.driver --n2d-demo [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..config import (DataConfig, PointNeRFConfig, hits_tracked,
                      scene_config, tiny_test_config)
from ..data import find_dataset_class_by_name
from ..data.synthetic import ring_cameras, sphere_scene, view_ray_batch
from ..models.aggregator import init_aggregator_params
from ..models.nerf_branch import init_nerf_params
from ..models.points import make_point_cloud
from ..models.renderer import ray_batch_from_numpy
from ..ops.voxel import construct_vox_points_closest
from ..utils.metrics import lpips_proxy, psnr, rmse, ssim
from ..utils.visualizer import Visualizer
from .checkpoint import (checkpoint_meta, latest_checkpoint, load_checkpoint,
                         save_checkpoint)
from .grow import (apply_grow, apply_prune, probe_hole, render_full_frame,
                   split_high_grad)
from .step import create_train_state, refresh_grid, train_step


class ItemPrefetcher:
    """Builds the next items (numpy ray batches) on a background thread
    while the device works on the current step."""

    def __init__(self, item_fn, start_step: int, depth: int = 4):
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None

        def worker():
            step = start_step
            while not self._stop.is_set():
                step += 1
                try:
                    payload = (step, item_fn(step))
                except Exception as e:  # raised again in get()
                    self._err = e
                    return
                while not self._stop.is_set():
                    try:
                        self._q.put(payload, timeout=1.0)
                        break
                    except queue.Full:
                        continue
        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def get(self):
        while True:
            if self._err is not None:
                raise RuntimeError("item prefetch worker failed") from self._err
            try:
                return self._q.get(timeout=5.0)
            except queue.Empty:
                continue

    def close(self):
        self._stop.set()
        self._t.join(timeout=10.0)


def init_mlp_params(generator: torch.Generator, cfg: PointNeRFConfig,
                    device: DeviceLike = None):
    """The MLP parameter tree of a run (every entry point that builds or
    restores one uses this, so hybrid checkpoints round-trip): the
    aggregator's, and the radiance field's under "nerf" when
    nerf_importance > 0 (drawn after the aggregator's from the same
    generator). The field sits in the "mlp" group: it shares the
    aggregator's Adam and learning rate, as in JAX."""
    params = init_aggregator_params(cfg.agg, generator, device=device)
    if cfg.render.nerf_importance > 0:
        params["nerf"] = init_nerf_params(generator, cfg, device=device)
    return params


def evaluate(params, st, grid, cfg: PointNeRFConfig, items: List[Dict], wh,
             vis: Visualizer, step: int, save_images: bool = False,
             lpips: bool = False, eval_chunk: int = 9216) -> Dict[str, float]:
    """Full-frame test pass: mean PSNR, SSIM and RMSE over `items` (and the
    LPIPS proxy with `lpips`). Frames render in chunks of `eval_chunk` rays,
    or 2304 when a frame is smaller than that."""
    W, H = wh
    psnrs, ssims, rmses, lprox = [], [], [], []
    chunk = eval_chunk if W * H >= eval_chunk else 2304
    for i, item in enumerate(items):
        maps = render_full_frame(params, st, grid, cfg, item, wh, chunk=chunk,
                                 prob=False)
        img = maps["coarse_raycolor"][..., :3]
        gt = np.zeros((H, W, 3), np.float32)
        pix = np.asarray(item["pixel_idx"], np.int64)
        gt[pix[:, 1], pix[:, 0]] = np.asarray(item["gt_image"], np.float32)
        psnrs.append(psnr(img, gt))
        ssims.append(ssim(img, gt))
        rmses.append(rmse(img, gt))
        if lpips:
            lprox.append(lpips_proxy(img, gt))
        if save_images:
            vis.save_image(img, f"step{step:08d}-{i:02d}.png")
    out = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
           "rmse": float(np.mean(rmses))}
    if lprox:
        out["lpips_proxy"] = float(np.mean(lprox))
    return out


def _save(run_dir, state, st):
    save_checkpoint(run_dir, state,
                    {"num_active": int(st.num_active),
                     "capacity": state.params["points"].capacity})


def train_scene(cfg: PointNeRFConfig,
                scene_pts: Tuple[np.ndarray, np.ndarray, np.ndarray],
                train_items_fn, test_items: List[Dict],
                probe_items: List[Dict], wh: Tuple[int, int],
                run_dir: str = "runs/scene", max_steps: Optional[int] = None,
                resume: bool = False, log_every: Optional[int] = None,
                target_psnr: Optional[float] = None,
                features: Optional[np.ndarray] = None,
                conf: Optional[np.ndarray] = None,
                sampler=None, device: DeviceLike = None):
    """Optimize one scene. `train_items_fn(step)` yields a numpy ray-batch
    item (as `data.synthetic.view_ray_batch`); `features`/`conf` seed the
    point payloads when given, else they start per
    cfg.points.feature_init_method. `sampler` (train/sampler.
    ErrorMapSampler, optional) receives each step's per-ray errors.
    Randomness comes from cfg.train.seed: the features from
    torch.Generator seed, the MLP weights from seed + 1, the jitter from a
    generator on the device seeded with seed + 2.

    Returns (state, st, history): history["loss"] holds (step, mean total
    loss) at the log cadence, history["eval"] the eval results."""
    dev = resolve_device(device)
    xyz, color, normals = scene_pts
    vis = Visualizer(run_dir, name=os.path.basename(run_dir))
    vis.save_options(cfg.to_json())
    seed = cfg.train.seed
    if features is not None and features.shape[1] != cfg.agg.point_features_dim:
        features = None  # the aggregator wants another width: init instead

    def fresh_state(capacity=None):
        pc, st = make_point_cloud(
            xyz, torch.Generator().manual_seed(seed), cfg.points,
            cfg.agg.point_features_dim, features=features, conf=conf,
            color=color, dirs=normals, capacity=capacity, device=dev)
        params = init_mlp_params(torch.Generator().manual_seed(seed + 1), cfg,
                                 device=dev)
        key = torch.Generator(device=dev).manual_seed(seed + 2)
        return create_train_state(key, params, pc, cfg), st

    state, st = fresh_state()
    if resume:
        path = latest_checkpoint(run_dir)
        if path:
            meta = checkpoint_meta(path)
            cap = meta.get("capacity")
            if cap is not None and cap != state.params["points"].capacity:
                # growth re-bucketed the cloud: the template at that size
                state, st = fresh_state(capacity=cap)
            state, meta = load_checkpoint(path, state)
            if meta.get("num_active") is not None:
                st = st._replace(num_active=torch.tensor(
                    meta["num_active"], dtype=torch.int32, device=dev))
            print(f"resumed from {path} at step {int(state.step)}")

    history = {"loss": [], "eval": []}
    grid, max_d = refresh_grid(state.params["points"], st, cfg)
    max_steps = max_steps or cfg.train.maximum_step
    log_every = log_every or cfg.train.print_freq
    t = cfg.train
    t0 = time.time()
    step_i = int(state.step)
    prefetch = ItemPrefetcher(train_items_fn, start_step=step_i)
    # per-view tallies of missed rays (device scalars) for ranking the
    # probe frames; folded to one scalar per view at the log cadence
    miss_tally: Dict = {}
    try:
        while step_i < max_steps:
            step_i += 1
            if (t.prune_iter > 0 and step_i % t.prune_iter == 0
                    and step_i <= t.prune_max_iter):
                state, st, kept = apply_prune(state, st, cfg)
                grid, max_d = refresh_grid(state.params["points"], st, cfg,
                                           max_d=max_d)
                print(f"[prune] step {step_i}: kept {kept} points")
            if t.prob_freq > 0 and step_i % t.prob_freq == 0 and probe_items:
                ranked = probe_items
                if miss_tally:
                    # the frames whose batches missed the most rays
                    ids = list(miss_tally)
                    totals = torch.stack([torch.stack(miss_tally[k]).sum()
                                          for k in ids]).cpu().tolist()
                    score = dict(zip(ids, totals))
                    ranked = sorted(probe_items,
                                    key=lambda it: -score.get(it.get("id"), 0))
                    n_probe = max(1, len(ranked) // max(t.prob_num_step, 1))
                    ranked = ranked[:n_probe]
                    miss_tally.clear()
                cand = probe_hole(state.params, st, grid, cfg, ranked, wh)
                state, st, added = apply_grow(state, st, cand, cfg)
                if added:
                    grid, max_d = refresh_grid(state.params["points"], st,
                                               cfg, max_d=max_d)
                print(f"[grow] step {step_i}: +{added} points "
                      f"(total {int(st.num_active)})")
            if (t.split_iter > 0 and step_i % t.split_iter == 0
                    and step_i <= t.prune_max_iter):
                state, st, added = split_high_grad(state, st, cfg)
                if added:
                    grid, max_d = refresh_grid(state.params["points"], st,
                                               cfg, max_d=max_d)
                print(f"[split] step {step_i}: +{added} points "
                      f"(total {int(st.num_active)})")

            fetched_step, item = prefetch.get()
            if fetched_step != step_i:
                raise RuntimeError(f"prefetched item of step {fetched_step} "
                                   f"at step {step_i}")
            batch = ray_batch_from_numpy(item, cfg, device=dev)
            state, items = train_step(state, st, grid, batch, cfg)
            n_miss = items.pop("n_miss")
            if t.prob_freq > 0 and probe_items and item.get("id") is not None:
                miss_tally.setdefault(item["id"], []).append(n_miss)
            per_ray_err = items.pop("per_ray_err", None)
            if sampler is not None and per_ray_err is not None:
                sampler.record(item.get("id"), item["pixel_idx"], per_ray_err)
            vis.accumulate_losses(items)

            if step_i % log_every == 0:
                if sampler is not None:
                    sampler.flush()
                miss_tally = {k: [torch.stack(vs).sum()]
                              for k, vs in miss_tally.items()}
                means = vis.print_losses(step_i)
                history["loss"].append((step_i, means.get("loss_total", 0.0)))
            if t.test_freq > 0 and step_i % t.test_freq == 0 and test_items:
                m = evaluate(state.params, st, grid, cfg, test_items, wh, vis,
                             step_i, save_images=True,
                             lpips=step_i + t.test_freq > max_steps)
                m["step"] = step_i
                m["wall_s"] = time.time() - t0
                if state.hits is not None and hits_tracked(cfg):
                    h = state.hits[:max(1, int(st.num_active)), 0].cpu().numpy()
                    m["hits_pct"] = {str(q): round(float(np.percentile(h, q)),
                                                   1)
                                     for q in (1, 5, 25, 50, 90)}
                history["eval"].append(m)
                print(f"[eval] step {step_i}: psnr={m['psnr']:.2f} "
                      f"ssim={m['ssim']:.4f} t={m['wall_s']:.0f}s")
                if target_psnr is not None and m["psnr"] >= target_psnr:
                    print(f"[done] reached target PSNR {target_psnr}")
                    break
            if t.save_iter_freq > 0 and step_i % t.save_iter_freq == 0:
                _save(run_dir, state, st)
    finally:
        prefetch.close()
    _save(run_dir, state, st)
    return state, st, history


def demo_config(steps: int) -> PointNeRFConfig:
    """tiny_test_config with the port's query (prebuilt neighbor tables,
    K1) and kernels on, and a schedule that prunes, grows and evaluates
    within `steps`."""
    cfg = tiny_test_config()
    return cfg.replace(
        query=dataclasses.replace(cfg.query, prebuild_neighbors=True,
                                  shell_layered=False, knn_select="pallas"),
        agg=dataclasses.replace(cfg.agg, fused_decode=True),
        render=dataclasses.replace(cfg.render, fused_march=True),
        train=dataclasses.replace(
            cfg.train, maximum_step=steps, prune_iter=max(steps // 2, 1),
            prune_max_iter=steps, prob_freq=max(steps // 2 + 1, 1),
            test_freq=max(steps // 2, 1), print_freq=50,
            save_iter_freq=steps, random_sample_size=16))


def demo(steps: int = 300, n_pts: int = 2048, wh=(64, 64),
         run_dir: str = "runs/demo", device: DeviceLike = None):
    """A small end-to-end run on the synthetic sphere (analytic ground
    truth), with prune, grow and eval once each."""
    cfg = demo_config(steps)
    xyz, color, normals = sphere_scene(n_pts=n_pts)
    views = ring_cameras(n_views=6, wh=wh, focal=float(wh[0]))
    rng = np.random.RandomState(0)

    def train_item(step):
        campos, rot, K = views[rng.randint(0, len(views) - 1)]
        return view_ray_batch(campos, rot, K, wh,
                              n_rays=cfg.train.random_sample_size ** 2,
                              seed=step)

    test_items = [view_ray_batch(*views[-1], wh)]
    probe_items = [view_ray_batch(*views[0], wh)]
    _state, _st, hist = train_scene(
        cfg, (xyz, color, normals), train_item, test_items, probe_items, wh,
        run_dir=run_dir, max_steps=steps, device=device)
    print("final eval:", hist["eval"][-1] if hist["eval"] else "(none)")
    return hist


def n2d_demo(steps: int = 40, patch: int = 16, device: DeviceLike = None):
    """Feature-render + CNN-head demo: 16-channel feature rays of random
    64 x 64 view patches decoded to RGB by the 2D neural renderer on the
    synthetic sphere. Returns the final Neural2DState."""
    from ..camera import get_dtu_raydir
    from ..data.synthetic import sphere_gt_render
    from ..models.neural_render import NeuralRenderer, init_neural_render
    from ..models.renderer import RayBatch
    from .neural2d import create_neural2d_state, make_neural2d_step
    dev = resolve_device(device)
    C = 16
    cfg = tiny_test_config()
    cfg = cfg.replace(agg=dataclasses.replace(
        cfg.agg, shading_color_channel_num=C))
    xyz, color, normals = sphere_scene(n_pts=2048)
    pc, st = make_point_cloud(xyz, torch.Generator().manual_seed(0),
                              cfg.points, cfg.agg.point_features_dim,
                              color=color, dirs=normals, device=dev)
    params = init_aggregator_params(cfg.agg, torch.Generator().manual_seed(1),
                                    device=dev)
    grid, _max_d = refresh_grid(pc, st, cfg)
    head = NeuralRenderer(n_feat=32, input_dim=C, img_size=64, min_feat=8)
    hp = init_neural_render(head, torch.Generator().manual_seed(2), dev)
    state = create_neural2d_state(torch.Generator(device=dev).manual_seed(3),
                                  params, pc, hp)
    step = make_neural2d_step(cfg, head, patch)

    campos, rot, K = ring_cameras(n_views=1, wh=(64, 64), focal=64.0)[0]
    rng = np.random.RandomState(0)

    def t(a, dt=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dt, device=dev)
    for i in range(steps):
        x0, y0 = rng.randint(0, 64 - patch, 2)
        gx, gy = np.meshgrid(np.arange(x0, x0 + patch),
                             np.arange(y0, y0 + patch))
        pix = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
        raydir = get_dtu_raydir(pix, K, rot, True).astype(np.float32)
        gt = sphere_gt_render(campos, raydir).reshape(patch, patch, 3)
        batch = RayBatch(campos=t(campos), camrotc2w=t(rot), raydir=t(raydir),
                         pixel_idx=t(pix, torch.int32),
                         near=t(cfg.render.near_plane),
                         far=t(cfg.render.far_plane), gt_image=None)
        state, items = step(state, st, grid, batch, t(gt), 0)
        if i % 10 == 0 or i == steps - 1:
            print(f"[n2d] step {i}: loss={float(items['loss_total']):.5f} "
                  f"psnr={float(items['psnr']):.2f}")
    return state


def mvs_init_cloud(ds, mvs_variables: Optional[Dict] = None,
                   n_groups: int = 8, point_features_dim: int = 32,
                   depth_conf_thresh: float = 0.8,
                   geo_cnsst_num: Optional[int] = None,
                   device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """A scene's initial cloud from MVS over the dataset's view groups (the
    first `n_groups` of `ds.get_mvs_item`): MVSNet depth at
    min(64, len(depth_values)) planes, the geometric filter
    (geo_cnsst_num defaults to min(3, V - 1)), the point embedding.
    `mvs_variables` ({"params", "batch_stats"} of an MvsPointsInit, e.g. a
    feed-forward-trained one) default to `init_mvs_points` from seed 0.
    Returns numpy xyz, feature, color, normal, conf."""
    from ..mvs.points_init import gen_scene_points, init_mvs_points, \
        new_mvs_model
    dev = resolve_device(device)
    g0 = ds.get_mvs_item(0)
    V = g0["images"].shape[0]
    model = new_mvs_model(point_features_dim, n_views=V, device=dev)
    if mvs_variables is None:
        mvs_variables = init_mvs_points(model,
                                        torch.Generator().manual_seed(0))
    outs = []
    for gi in range(min(n_groups, len(ds))):
        g = ds.get_mvs_item(gi)
        gc = geo_cnsst_num if geo_cnsst_num is not None else \
            min(3, g["images"].shape[0] - 1)
        outs.append(gen_scene_points(
            mvs_variables["params"], model, g["images"], g["Ks"], g["w2cs"],
            (float(g["depth_values"][0]), float(g["depth_values"][-1])),
            n_depths=min(64, len(g["depth_values"])),
            depth_conf_thresh=depth_conf_thresh, geo_cnsst_num=gc,
            batch_stats=mvs_variables.get("batch_stats")))
    return {"xyz": np.concatenate([o["xyz"] for o in outs]),
            "feature": np.concatenate([o["embedding"] for o in outs]),
            "color": np.concatenate([o["color"] for o in outs]),
            "normal": np.concatenate([o["dirs"] for o in outs]),
            "conf": np.concatenate([o["conf"] for o in outs])}


def _init_cloud(ds, mvs_init_kwargs: Optional[Dict], device):
    """The dataset's init cloud on disk, or, for a dataset of MVS view
    groups without one, `mvs_init_cloud(**mvs_init_kwargs)`."""
    try:
        return ds.load_init_points()
    except (FileNotFoundError, AttributeError):
        if not hasattr(ds, "get_mvs_item"):
            raise
        return mvs_init_cloud(ds, device=device, **(mvs_init_kwargs or {}))


def train_dataset_scene(dataset_name: str, data_root: str, scan: str,
                        run_dir: str, max_steps: Optional[int] = None,
                        cfg: Optional[PointNeRFConfig] = None,
                        resume: bool = True,
                        mvs_init_kwargs: Optional[Dict] = None,
                        device: DeviceLike = None):
    """Per-scene optimization on a dataset on disk: load the init cloud
    (or build it with `mvs_init_cloud` and `mvs_init_kwargs` where the
    dataset has none), size the config from its AABB (`scene_config`)
    unless one is given, voxel-downsample a cloud above 2M points, sample
    `random_sample_size`^2 rays of a random training view per step, and
    evaluate on every eighth test view. Returns train_scene's
    (state, st, history)."""
    dev = resolve_device(device)
    dcfg = DataConfig(dataset_name=dataset_name, data_root=data_root,
                      scan=scan)
    cls = find_dataset_class_by_name(dataset_name)
    train_ds = cls(dcfg, split="train")
    test_ds = cls(dcfg, split="test")
    cloud = _init_cloud(train_ds, mvs_init_kwargs, dev)
    xyz = cloud["xyz"]
    if cfg is None:
        cfg = scene_config(xyz, near=float(train_ds.near),
                           far=float(train_ds.far))
    if xyz.shape[0] > 2_000_000:
        idx, _ = construct_vox_points_closest(xyz, cfg.points.vox_res,
                                              device=dev)
        cloud = {k: v[idx] for k, v in cloud.items()}
        xyz = cloud["xyz"]
    wh = (train_ds.width, train_ds.height)
    rng = np.random.RandomState(cfg.train.seed)

    def train_item(step):
        i = rng.randint(0, len(train_ds))
        return train_ds.get_item(
            i, random_sample=cfg.train.random_sample,
            random_sample_size=cfg.train.random_sample_size, seed=step)

    test_items = [test_ds.get_item(i) for i in
                  range(0, len(test_ds), max(1, len(test_ds) // 8))]
    probe_items = [train_ds.get_item(i) for i in
                   range(0, len(train_ds), max(1, len(train_ds) // 4))]
    return train_scene(cfg, (xyz, cloud.get("color"), cloud.get("normal")),
                       train_item, test_items, probe_items, wh,
                       run_dir=run_dir, max_steps=max_steps, resume=resume,
                       features=cloud.get("feature"), conf=cloud.get("conf"),
                       device=dev)


def _restore_latest(train_ds, run_dir: str,
                    cfg: Optional[PointNeRFConfig], mvs_init_kwargs, dev):
    """The latest checkpoint under `run_dir` of a scene trained by
    train_dataset_scene: (state, st, grid, cfg). The init cloud (for the
    config and the template the checkpoint fills) comes as there, MVS
    included; the template is built at the checkpoint's capacity (growth
    may have re-bucketed the cloud, a downsample shrunk it)."""
    cloud = _init_cloud(train_ds, mvs_init_kwargs, dev)
    if cfg is None:
        cfg = scene_config(cloud["xyz"], near=float(train_ds.near),
                           far=float(train_ds.far))
    path = latest_checkpoint(run_dir)
    if path is None:
        raise SystemExit(f"no checkpoint under {run_dir}")
    cap = checkpoint_meta(path).get("capacity")
    n = cloud["xyz"].shape[0] if cap is None else min(cap,
                                                      cloud["xyz"].shape[0])
    pc, st = make_point_cloud(cloud["xyz"][:n], torch.Generator().manual_seed(
        cfg.train.seed), cfg.points, cfg.agg.point_features_dim,
        capacity=cap, device=dev)
    params = init_mlp_params(torch.Generator().manual_seed(
        cfg.train.seed + 1), cfg, device=dev)
    state = create_train_state(torch.Generator(device=dev), params, pc, cfg)
    state, meta = load_checkpoint(path, state)
    if meta.get("num_active") is not None:
        st = st._replace(num_active=torch.tensor(
            meta["num_active"], dtype=torch.int32, device=dev))
    grid, _ = refresh_grid(state.params["points"], st, cfg)
    return state, st, grid, cfg


def render_video(params, st, grid, cfg: PointNeRFConfig, items: List[Dict],
                 wh: Tuple[int, int], run_dir: str, name: str = "spiral",
                 fps: int = 24, container: Optional[str] = None) -> str:
    """Render a pose sequence (full frames through `render_full_frame`:
    K3 and K2 on the card) and write it with `Visualizer.gen_video`: a
    directory of numbered PNG frames, or a `container` file ("mp4",
    "gif") where imageio is installed. Returns its path."""
    vis = Visualizer(run_dir, name=name)
    frames = []
    for item in items:
        maps = render_full_frame(params, st, grid, cfg, item, wh,
                                 chunk=9216 if wh[0] * wh[1] >= 9216 else 2304,
                                 prob=False)
        frames.append(np.clip(maps["coarse_raycolor"][..., :3], 0, 1))
    return vis.gen_video(frames, name=name, fps=fps, container=container)


def render_video_from_checkpoint(dataset_name: str, data_root: str,
                                 scan: str, run_dir: str,
                                 cfg: Optional[PointNeRFConfig] = None,
                                 n_frames: int = 40, fps: int = 12,
                                 container: Optional[str] = None,
                                 mvs_init_kwargs: Optional[Dict] = None,
                                 device: DeviceLike = None) -> str:
    """A spiral video of the latest checkpoint under `run_dir`: frame i of
    n_frames is the dataset's `get_dummyrot_item(i, n_frames)` (nerf_synth
    and dtu_ft have one). Returns render_video's path."""
    dev = resolve_device(device)
    dcfg = DataConfig(dataset_name=dataset_name, data_root=data_root,
                      scan=scan)
    ds = find_dataset_class_by_name(dataset_name)(dcfg, split="train")
    if not hasattr(ds, "get_dummyrot_item"):
        raise SystemExit(f"{dataset_name} has no spiral render path")
    state, st, grid, cfg = _restore_latest(ds, run_dir, cfg,
                                           mvs_init_kwargs, dev)
    items = [ds.get_dummyrot_item(i, n_frames=n_frames)
             for i in range(n_frames)]
    out = render_video(state.params, st, grid, cfg, items,
                       (ds.width, ds.height), run_dir, fps=fps,
                       container=container)
    print("video:", out)
    return out


def test_dataset_scene(dataset_name: str, data_root: str, scan: str,
                       run_dir: str, cfg: Optional[PointNeRFConfig] = None,
                       save_images: bool = True,
                       mvs_init_kwargs: Optional[Dict] = None,
                       device: DeviceLike = None) -> Dict[str, float]:
    """Evaluate the latest checkpoint under `run_dir` on the whole test
    split: PSNR / SSIM / RMSE, and the rendered frames under
    `run_dir/images` with `save_images`. The init cloud (for the config
    and the template the checkpoint fills) comes as in
    `train_dataset_scene`, MVS included."""
    dev = resolve_device(device)
    dcfg = DataConfig(dataset_name=dataset_name, data_root=data_root,
                      scan=scan)
    cls = find_dataset_class_by_name(dataset_name)
    train_ds = cls(dcfg, split="train")
    test_ds = cls(dcfg, split="test")
    state, st, grid, cfg = _restore_latest(train_ds, run_dir, cfg,
                                           mvs_init_kwargs, dev)
    vis = Visualizer(run_dir, name="test")
    items = [test_ds.get_item(i) for i in range(len(test_ds))]
    m = evaluate(state.params, st, grid, cfg, items,
                 (test_ds.width, test_ds.height), vis, int(state.step),
                 save_images=save_images)
    print(f"[test] step {int(state.step)}: psnr={m['psnr']:.2f} "
          f"ssim={m['ssim']:.4f} over {len(items)} frames")
    return m


def ff_demo_config() -> PointNeRFConfig:
    """The feed-forward demo's config (the JAX package's ff_demo)."""
    from ..config import (AggregatorConfig, QueryConfig, RenderConfig)
    return PointNeRFConfig(
        query=QueryConfig(vsize=(0.1, 0.1, 0.1), vscale=(2.0, 2.0, 2.0),
                          max_o=2048, P=8, K=4, SR=12, z_depth_dim=48,
                          ranges=(-2.0, -2.0, -2.0, 2.0, 2.0, 2.0),
                          knn_chunk=4096),
        agg=AggregatorConfig(point_features_dim=8, shading_feature_num=32,
                             num_feat_freqs=2, dist_xyz_freq=3,
                             num_pos_freqs=4, num_viewdir_freqs=2),
        render=RenderConfig(near_plane=2.0, far_plane=4.5))


def _mvs_batch(images, Ks, w2cs, depth_values, rays, dev):
    """An MVSBatch on `dev` from one numpy view group (view 0 the
    reference; images [V, H, W, 3])."""
    from ..mvs.points_init import images_nchw, view_proj_mats
    from .feedforward import MVSBatch

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return MVSBatch(images=images_nchw(images, dev),
                    proj_mats=t(view_proj_mats(Ks, w2cs, 0)), Ks=t(Ks),
                    w2cs=t(w2cs), depth_values=t(depth_values), rays=rays)


def ff_demo(steps: int = 20, wh=(32, 32), device: DeviceLike = None):
    """Feed-forward (generalization) demo on the synthetic sphere: three
    ring views -> MVSNet -> points -> render a fourth view's rays, the
    gradients into the MVS nets. Returns the final FFState."""
    from ..mvs.points_init import init_mvs_points, new_mvs_model
    from .feedforward import create_ff_state, make_feedforward_step
    dev = resolve_device(device)
    cfg = ff_demo_config()
    V = 3
    views = ring_cameras(n_views=V + 1, wh=wh, focal=float(wh[0]))
    images, Ks, w2cs = [], [], []
    for campos, rot, K in views[:V]:
        item = view_ray_batch(campos, rot, K, wh)
        images.append(item["gt_image"].reshape(wh[1], wh[0], 3))
        Ks.append(K)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = rot.T
        w2c[:3, 3] = -rot.T @ campos
        w2cs.append(w2c)
    images, Ks, w2cs = np.stack(images), np.stack(Ks), np.stack(w2cs)
    model = new_mvs_model(cfg.agg.point_features_dim, n_views=V, device=dev)
    variables = init_mvs_points(model, torch.Generator().manual_seed(0))
    agg_params = init_aggregator_params(
        cfg.agg, torch.Generator().manual_seed(1), device=dev)
    state = create_ff_state(torch.Generator(device=dev).manual_seed(2),
                            variables, agg_params, cfg)
    step, _infer = make_feedforward_step(cfg, model,
                                         capacity=(wh[0] // 4) ** 2 * 2)
    depth_values = np.linspace(2.0, 4.5, 16, dtype=np.float32)
    for i in range(steps):
        target = view_ray_batch(*views[V], wh, n_rays=64, seed=i)
        batch = _mvs_batch(images, Ks, w2cs, depth_values,
                           ray_batch_from_numpy(target, cfg, device=dev), dev)
        state, items = step(state, batch)
        if i % 5 == 0 or i == steps - 1:
            print(f"[ff] step {i}: loss={float(items['loss_total']):.5f} "
                  f"psnr={float(items['psnr']):.2f}")
    return state


def train_feedforward_dataset(data_root: str, scan: str, run_dir: str,
                              max_steps: int = 1000,
                              cfg: Optional[PointNeRFConfig] = None,
                              nsrc: int = 2, n_depths: int = 48,
                              n_rays: int = 1024, log_every: int = 50,
                              device: DeviceLike = None):
    """Generalization training on a DTU-format dataset: per step, one MVS
    view group (a random one) builds a fresh differentiable cloud and
    sqrt(n_rays)^2 random rays of its reference view supervise both the
    shading MLPs and the MVS nets. Without `cfg`, scene_config of a cube
    of the depth range's span. Returns (state, infer_cloud)."""
    from ..mvs.points_init import init_mvs_points, new_mvs_model
    from .feedforward import create_ff_state, make_feedforward_step
    dev = resolve_device(device)
    dcfg = DataConfig(dataset_name="dtu", data_root=data_root, scan=scan)
    ds = find_dataset_class_by_name("dtu")(dcfg, split="train", nsrc=nsrc,
                                           n_depths=n_depths)
    g0 = ds.get_mvs_item(0)
    V, H, W = g0["images"].shape[:3]
    if cfg is None:
        near, far = float(g0["depth_values"][0]), float(g0["depth_values"][-1])
        span = far - near
        cfg = scene_config(np.array([[-span, -span, -span],
                                     [span, span, span]], np.float32),
                           near=near, far=far)
    model = new_mvs_model(cfg.agg.point_features_dim, n_views=V, device=dev)
    variables = init_mvs_points(model, torch.Generator().manual_seed(0))
    agg_params = init_aggregator_params(
        cfg.agg, torch.Generator().manual_seed(1), device=dev)
    state = create_ff_state(torch.Generator(device=dev).manual_seed(2),
                            variables, agg_params, cfg)
    step_fn, infer_cloud = make_feedforward_step(
        cfg, model, capacity=(H // 4) * (W // 4))
    vis = Visualizer(run_dir, name="feedforward")
    rng = np.random.RandomState(cfg.train.seed)
    for i in range(max_steps):
        gi = rng.randint(0, len(ds))
        g = ds.get_mvs_item(gi)
        item = ds.get_item(gi, random_sample="random",
                           random_sample_size=int(np.sqrt(n_rays)), seed=i)
        batch = _mvs_batch(g["images"], g["Ks"], g["w2cs"],
                           g["depth_values"],
                           ray_batch_from_numpy(item, cfg, device=dev), dev)
        state, items = step_fn(state, batch)
        vis.accumulate_losses(items)
        if (i + 1) % log_every == 0:
            vis.print_losses(i + 1)
    return state, infer_cloud


def main():
    ap = argparse.ArgumentParser(description="Per-scene optimization of the "
                                 "PyTorch port")
    ap.add_argument("--demo", action="store_true",
                    help="a small end-to-end run on the synthetic sphere")
    ap.add_argument("--dataset", default=None,
                    help="per-scene training on a dataset on disk: its "
                         "registered name (nerf_synth360_ft, "
                         "nerf_synth_ft, tt_ft, nsvf, waymo_ft, dtu, "
                         "dtu_ft, llff_ft, scannet_ft)")
    ap.add_argument("--data-root", default="")
    ap.add_argument("--scan", default="lego")
    ap.add_argument("--test", action="store_true",
                    help="evaluate the latest checkpoint on the test split "
                         "(with --dataset/--data-root/--scan)")
    ap.add_argument("--video", action="store_true",
                    help="render a spiral video (PNG frames) from the latest "
                         "checkpoint (with --dataset/--data-root/--scan)")
    ap.add_argument("--ff-demo", action="store_true",
                    help="feed-forward (MVS generalization) demo")
    ap.add_argument("--ff-dataset", action="store_true",
                    help="feed-forward generalization training on a "
                         "DTU-format --data-root/--scan")
    ap.add_argument("--n2d-demo", action="store_true",
                    help="feature rendering + 2D neural-render head demo")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--run-dir", default="runs/demo")
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    args = ap.parse_args()
    if args.dataset and args.video:
        render_video_from_checkpoint(args.dataset, args.data_root, args.scan,
                                     run_dir=args.run_dir, device=args.device)
    elif args.ff_dataset:
        train_feedforward_dataset(args.data_root, args.scan,
                                  run_dir=args.run_dir, max_steps=args.steps,
                                  device=args.device)
    elif args.dataset and args.test:
        test_dataset_scene(args.dataset, args.data_root, args.scan,
                           run_dir=args.run_dir, device=args.device)
    elif args.dataset:
        train_dataset_scene(args.dataset, args.data_root, args.scan,
                            run_dir=args.run_dir, max_steps=args.steps,
                            device=args.device)
    elif args.demo:
        demo(steps=args.steps, run_dir=args.run_dir, device=args.device)
    elif args.ff_demo:
        ff_demo(steps=min(args.steps, 50), device=args.device)
    elif args.n2d_demo:
        n2d_demo(steps=min(args.steps, 100), device=args.device)
    else:
        ap.error("use --demo, --ff-demo, --n2d-demo, --ff-dataset or "
                 "--dataset NAME --data-root DIR --scan NAME")


if __name__ == "__main__":
    main()
