"""One cell of the benchmark: a configuration under a traffic mix, built
from the seed, driven through the program's entry points, and checked
against the plain reference.

The traffic file's "kind" picks the loop, and its numbers size it:

- "train": `train_step` on batches of random_sample_size^2 rays, each drawn
  uniformly from a training view picked at random, made at set-up into a
  pool in host memory with their analytic ground truth and handed over the
  way `train_dataset_scene` hands its batches (`ray_batch_from_numpy`, so
  every step pays its host-to-device copy). A closed loop: one step after
  another.
- "render": whole test frames through `render_full_frame(prob=False)` at
  the traffic's chunk, as `driver.evaluate` calls it, the poses cycling
  over the test views. A closed loop: one frame after another.

From the program this module takes the system under test and its kernel
entry points only; the scene, the weights, the batches and the reference
are the benchmark's own.
"""
from __future__ import annotations

import json
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import scene as scenes
from .reference import plain

LEAKY_GAIN = math.sqrt(2.0 / (1.0 + 0.01 ** 2))


def substream(seed: int, stream: int) -> np.random.RandomState:
    """An independent numpy stream of the seed, for any whole seed."""
    s = np.random.SeedSequence([seed % (1 << 64), stream])
    return np.random.RandomState(s.generate_state(1)[0])


def torch_seed(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence([seed % (1 << 64), stream])
               .generate_state(2, np.uint64)[0] >> np.uint64(1))


def mlp_dims(agg: Dict) -> Dict[str, List[int]]:
    """Layer widths of the aggregator's MLPs in the fused decode's layout
    (block1 over [features, their PE, the dists' PE]; block3 over [block1,
    color, dir - viewdir, dir . viewdir]; per-point alpha; the color head
    over [the interpolated feature, the view direction's PE])."""
    Fi, Ff, Fd = agg["point_features_dim"], agg["num_feat_freqs"], \
        agg["dist_xyz_freq"]
    Dd = 6 if agg["agg_dist_pers"] == 20 else None
    if Dd is None or agg["agg_intrp_order"] != 2 \
            or agg["agg_distance_kernel"] != "linear":
        raise ValueError("the benchmark's reference covers agg_dist_pers 20, "
                         "agg_intrp_order 2 and the linear kernel")
    H = agg["shading_feature_num"]
    x1 = Fi + 2 * Ff * Fi + 2 * Fd * Dd
    half = H // 2
    vd = 2 * agg["num_viewdir_freqs"] * 3
    return {"block1": [x1] + [H] * agg["shading_feature_mlp_layer1"],
            "block3": [H + 7] + [H] * agg["shading_feature_mlp_layer3"],
            "alpha": [H, 1],
            "color": [H + vd] + [half] * (agg["shading_color_mlp_layer"] - 1)
            + [agg["shading_color_channel_num"]]}


def make_mlp(agg: Dict, gen: torch.Generator, dev) -> Dict:
    """Xavier-uniform weights (gain of the leaky ReLU; 1 on the alpha and
    color heads' last layers) and zero biases, drawn on the device in one
    call."""
    dims = mlp_dims(agg)
    shapes = [(name, a, b, i == len(d) - 2)
              for name, d in dims.items()
              for i, (a, b) in enumerate(zip(d[:-1], d[1:]))]
    r = torch.rand(sum(a * b for _n, a, b, _l in shapes), generator=gen,
                   device=dev)
    out, off = {k: [] for k in dims}, 0
    for name, a, b, last in shapes:
        g = 1.0 if last and name in ("alpha", "color") else LEAKY_GAIN
        bound = g * math.sqrt(2.0 / (a + b)) * math.sqrt(3.0)
        w = (r[off:off + a * b].view(a, b) * 2 - 1) * bound
        off += a * b
        out[name].append({"w": w.contiguous(),
                          "b": torch.zeros(b, device=dev)})
    return out


def ray_item(cam: scenes.Camera, pix: np.ndarray) -> Dict:
    return {"campos": cam.campos, "camrotc2w": cam.rot,
            "raydir": scenes.get_dtu_raydir(pix.astype(np.float32), cam.K,
                                            cam.rot, True).astype(np.float32),
            "pixel_idx": pix.astype(np.int32)}


class Cell:
    """Build with `setup()`, drive with `unit()` and `window(seconds)`,
    read the program's answers and the reference's after
    `free_program()`."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        from pointnerf_tpu_torch.config import PointNeRFConfig
        self.config, self.traffic, self.seed = config, traffic, seed
        self.kind = traffic["kind"]
        if self.kind not in ("train", "render"):
            raise ValueError(f"unknown traffic kind {self.kind!r}")
        self.dev = torch.device(device)
        self.raw = config["pointnerf"]
        self.cfg = PointNeRFConfig.from_json(json.dumps(self.raw))
        self.units = 0                  # steps or frames driven so far
        self.samples: List[Dict] = []   # render: the answers kept to check

    # -- set-up --------------------------------------------------------------

    def setup(self):
        from pointnerf_tpu_torch.models.points import (DEAD_XYZ, PointCloud,
                                                       PointCloudStatic,
                                                       round_capacity)
        from pointnerf_tpu_torch.train.step import refresh_grid
        cfg, dev = self.cfg, self.dev
        self.scene = scenes.build_scene(
            self.config["scene"], cfg.query.ranges, cfg.points.vox_res,
            torch_seed(self.seed, 1), dev)
        gen = torch.Generator(device=dev).manual_seed(torch_seed(self.seed, 2))
        self.mlp0 = make_mlp(self.raw["agg"], gen, dev)
        n = self.scene.xyz.shape[0]
        cap = round_capacity(n)
        F = cfg.agg.point_features_dim

        def pad(a, fill=0.0):
            out = torch.full((cap, a.shape[1]), fill, device=dev)
            out[:n] = a
            return out
        feats = torch.rand((n, F), generator=gen, device=dev) * 0.01
        if self.kind == "render":
            lo, hi = self.traffic["served_conf"]
            conf = lo + (hi - lo) * torch.rand((n, 1), generator=gen,
                                               device=dev)
        else:
            conf = torch.full((n, 1), cfg.points.default_conf, device=dev)
        t = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731
        self.pts0 = plain.Payload(t(self.scene.xyz), feats, conf,
                                  t(self.scene.color), t(self.scene.normals))
        self.pc = PointCloud(xyz=pad(self.pts0.xyz, DEAD_XYZ),
                             features=pad(feats), conf=pad(conf),
                             color=pad(self.pts0.color),
                             dirs=pad(self.pts0.dirs))
        self.st = PointCloudStatic(
            num_active=torch.tensor(n, dtype=torch.int32, device=dev),
            Rw2c=torch.eye(3, device=dev))
        self.grid, _max_d = refresh_grid(self.pc, self.st, cfg)
        if self.kind == "train":
            self._setup_train()
        else:
            self._setup_render()

    def _setup_train(self):
        from pointnerf_tpu_torch.train.step import create_train_state
        rng = substream(self.seed, 3)
        W, H = self.scene.wh
        R = self.cfg.train.random_sample_size ** 2
        self.pool = []
        for _ in range(self.traffic["pool_batches"]):
            cam = self.scene.train_cams[rng.randint(len(self.scene.train_cams))]
            pix = np.stack([rng.randint(0, W, R), rng.randint(0, H, R)], -1)
            item = ray_item(cam, pix)
            item["gt_image"] = self.scene.gt(cam, item["raydir"])
            self.pool.append(item)
        self.key_seed = torch_seed(self.seed, 4)
        key = torch.Generator(device=self.dev).manual_seed(self.key_seed)
        self.state = create_train_state(key, self.mlp0, self.pc, self.cfg)
        self.kept = {}
        self.losses: List[torch.Tensor] = []
        checked = self.traffic["checked_steps"]
        for i in range(self.traffic["warmup_steps"]):
            self.unit()
            if i + 1 in (1, checked):
                self.kept[i + 1] = self.state
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _setup_render(self):
        W, H = self.scene.wh
        gx, gy = np.meshgrid(np.arange(W), np.arange(H))
        self.pix = np.stack([gx.ravel(), gy.ravel()], -1)
        K = self.scene.test_cams[0].K
        x = (self.pix[:, 0] + 0.5 - K[0, 2]) / K[0, 0]
        y = (self.pix[:, 1] + 0.5 - K[1, 2]) / K[1, 1]
        d = np.stack([x, y, np.ones_like(x)], -1).astype(np.float32)
        self.dcam = d / (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-5)
        self.pose0 = int(substream(self.seed, 5).randint(
            len(self.scene.test_cams)))
        self.sample_rng = substream(self.seed, 6)
        for _ in range(self.traffic["warmup_frames"]):
            self.unit()
        self.samples.clear()

    # -- the loop ------------------------------------------------------------

    def rays_per_unit(self) -> int:
        if self.kind == "train":
            return self.cfg.train.random_sample_size ** 2
        W, H = self.scene.wh
        return W * H

    def unit(self):
        """One step or one whole frame."""
        if self.kind == "train":
            self._step()
        else:
            self._frame()
        self.units += 1

    def _step(self):
        from pointnerf_tpu_torch.models.renderer import ray_batch_from_numpy
        from pointnerf_tpu_torch.train.step import train_step
        item = self.pool[self.units % len(self.pool)]
        with torch.profiler.record_function("portbench.unit"):
            batch = ray_batch_from_numpy(item, self.cfg, device=self.dev)
            self.state, items = train_step(self.state, self.st, self.grid,
                                           batch, self.cfg)
        if len(self.losses) < self.traffic["checked_steps"]:
            self.losses.append(items["loss_total"])

    def frame_item(self, f: int):
        cams = self.scene.test_cams
        cam = cams[(self.pose0 + f) % len(cams)]
        raydir = (self.dcam @ cam.rot.T).astype(np.float32)
        return cam, {"campos": cam.campos, "camrotc2w": cam.rot,
                     "raydir": raydir, "pixel_idx": self.pix}

    def _frame(self):
        from pointnerf_tpu_torch.train.grow import render_full_frame
        cam, item = self.frame_item(self.units)
        with torch.profiler.record_function("portbench.unit"):
            maps = render_full_frame({"mlp": self.mlp0, "points": self.pc},
                                     self.st, self.grid, self.cfg, item,
                                     self.scene.wh,
                                     chunk=self.traffic["chunk"], prob=False)
        self._keep(cam, item, maps)

    def _keep(self, cam, item, maps):
        """The answers of this frame the check will hold against the
        reference: a sample of its hit rays and of all its rays, drawn from
        the seed."""
        W, H = self.scene.wh
        mask = maps["ray_mask"][..., 0].reshape(-1) > 0
        hits = np.flatnonzero(mask)
        rng = self.sample_rng
        n_hit = min(self.traffic["checked_hit_rays"], hits.size)
        pick = np.concatenate([
            rng.choice(hits, n_hit, replace=False) if n_hit else
            np.zeros(0, np.int64),
            rng.randint(0, W * H, self.traffic["checked_any_rays"])])
        px, py = self.pix[pick, 0], self.pix[pick, 1]
        self.samples.append({
            "cam": cam, "raydir": item["raydir"][pick],
            "color": maps["coarse_raycolor"][py, px, :3].copy(),
            "mask": maps["ray_mask"][py, px, 0] > 0})

    def window(self, seconds: float, meter=None) -> Dict[str, float]:
        """Drive whole units until `seconds` have passed on the host clock;
        the window ends at the end of a unit, synchronized. With a
        `trace.WindowMeter`, the device's busy time over the whole window
        is read too (`device_busy_s`)."""
        sync = (lambda: torch.cuda.synchronize(self.dev)) \
            if self.dev.type == "cuda" else (lambda: None)
        sync()
        start_units = self.units
        t0 = time.perf_counter()
        if meter is not None:
            meter.start(0.0)
        ends = []
        while True:
            self.unit()
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
            if meter is not None:
                meter.tick(ends[-1])
        sync()
        wall = time.perf_counter() - t0
        n = self.units - start_units
        out = {"units": n, "wall_s": wall,
               "rays_per_s": n * self.rays_per_unit() / wall,
               "unit_ends_s": ends}
        if meter is not None:
            meter.stop()
            out["device_busy_s"] = meter.busy_s
            out["device_segments"] = meter.segments
        return out

    def free_program(self):
        """Drop the program's state and the device cache, keeping what the
        check reads."""
        for name in ("state", "grid", "pc"):
            if hasattr(self, name):
                setattr(self, name, None)
        self.kept = {}
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------------

    def program_train_readings(self):
        """The program's numbers of the check, read from its states after
        steps 1 and `checked_steps`: each step's loss, each leaf's first
        gradient (from Adam's first moment after one step: mu = 0.1 g) and
        each leaf's change over the checked steps. Point leaves are read
        over the live points (the program pads them to a capacity)."""
        s1, sn = self.kept[1], self.kept[self.traffic["checked_steps"]]
        n = self.pts0.xyz.shape[0]
        names = plain.leaf_names(self.mlp0)

        def flat(mlp, pts):
            return [t[:n] if k.startswith("points.") else t
                    for k, t in zip(names, plain.leaves(
                        mlp, plain.Payload(*pts)))]
        mu = flat(s1.opt_state["mlp"].mu, s1.opt_state["points"].mu)
        p0 = plain.leaves(self.mlp0, self.pts0)
        pn = flat(sn.params["mlp"], sn.params["points"])
        return {"losses": [float(x) for x in self.losses],
                "grad": {k: float(torch.linalg.norm(m.double() / 0.1))
                         for k, m in zip(names, mu)},
                "change": {k: float(torch.linalg.norm(b.double()
                                                      - a.double()))
                           for k, a, b in zip(names, p0, pn)}}

    def reference_train(self, quant: Optional[str] = None,
                        geo: Optional[plain.Geometry] = None):
        """The reference's numbers of the check, following the same steps
        from the benchmark's own initial state."""
        plain.no_tf32()
        n = self.traffic["checked_steps"]
        geo = geo or plain.Geometry(self.pts0.xyz, self.raw["query"])
        R, D = self.cfg.train.random_sample_size ** 2, \
            self.cfg.query.z_depth_dim
        gen = torch.Generator(device=self.dev).manual_seed(self.key_seed)
        draws = [torch.rand((R, D), generator=gen, device=self.dev)
                 for _ in range(n)]
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(  # noqa
            self.dev)
        batches = [{"campos": t(b["campos"]), "rot": t(b["camrotc2w"]),
                    "raydir": t(b["raydir"]), "gt": t(b["gt_image"])}
                   for b in self.pool[:n]]
        losses, grads, final = plain.train_steps(
            self.mlp0, self.pts0, geo, self.raw, batches, draws, quant=quant)
        init = dict(zip(plain.leaf_names(self.mlp0),
                        plain.leaves(self.mlp0, self.pts0)))
        return {"losses": losses,
                "grad": {k: float(torch.linalg.norm(g.double()))
                         for k, g in grads.items()},
                "change": {k: float(torch.linalg.norm(
                    final[k].double() - init[k].double())) for k in final}}

    def reference_colors(self, quant: Optional[str] = None,
                         geo: Optional[plain.Geometry] = None):
        """The reference's colors and masks of every kept answer."""
        plain.no_tf32()
        geo = geo or plain.Geometry(self.pts0.xyz, self.raw["query"])
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(  # noqa
            self.dev)
        cols, masks = [], []
        with torch.no_grad():
            for s in self.samples:
                out = plain.render(self.mlp0, self.pts0, geo, self.raw,
                                   t(s["cam"].campos), t(s["cam"].rot),
                                   t(s["raydir"]), quant=quant)
                cols.append(out.color.cpu().numpy())
                masks.append(out.ray_mask.cpu().numpy())
        return cols, masks
