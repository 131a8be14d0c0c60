"""Typed configuration of the PyTorch port.

Counterpart of `pointnerf_tpu/config.py`: the same frozen dataclasses with
the same fields and defaults, so one `opt.json` loads in both packages
(`to_json` / `from_json`). Fields that only choose a TPU formulation
(`knn_select`, `slot_select`, `knn_chunk`, `fused_tile*`, `remat`) are kept
for the round trip; the port reads the ones its slice needs.
The env-knob reader of the JAX package (`apply_bench_env_knobs`) is not
ported: the port adds no env knobs.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


def _t3(x) -> Tuple[float, float, float]:
    a, b, c = x
    return (float(a), float(b), float(c))


@dataclass(frozen=True)
class QueryConfig:
    """Voxel-grid neighbor query hyperparameters.

    Mirrors the flags consumed by the reference CUDA querier
    (reference: models/neural_points/query_point_indices_worldcoords.py:48-99,
    dev_scripts/w_n360/lego.sh:51-66).
    """
    vsize: Tuple[float, float, float] = (0.004, 0.004, 0.004)
    vscale: Tuple[float, float, float] = (2.0, 2.0, 2.0)
    kernel_size: Tuple[int, int, int] = (3, 3, 3)   # KNN shell search extent
    query_size: Tuple[int, int, int] = (3, 3, 3)    # occupancy dilation extent
    radius_limit_scale: float = 4.0
    depth_limit_scale: float = 0.0
    max_o: int = 830000          # max occupied voxels
    P: int = 9                   # max points stored per voxel
    K: int = 8                   # neighbors per shading point
    SR: int = 80                 # shading points per ray
    z_depth_dim: int = 400       # ray samples (D)
    NN: int = 2                  # >0: KNN; 0: first-K (reference query_rand)
    # Scene AABB (xmin,ymin,zmin,xmax,ymax,zmax). Must be concrete per scene so
    # grid shapes are static. reference: lego.sh:59
    ranges: Tuple[float, float, float, float, float, float] = (
        -0.638, -1.141, -0.346, 0.634, 1.149, 1.141)
    inverse: int = 0             # 1: disparity-linear ray sampling
    # emulate the reference CUDA layered shell search exactly (stop scanning
    # outer voxel shells once K in-radius candidates have been seen in
    # completed inner shells, reference worldcoords kernel :482-527).
    shell_layered: bool = True
    # chunk size (shading points) for the XLA KNN to bound gather memory
    knn_chunk: int = 65536
    # Shading-slot selection formulation (ops/query.select_shading_points):
    # "merge" = sort-merge occupancy membership (zero occupancy-table
    # gathers — two lax.sorts over samples + occupied-cell list; fastest
    # measured on-chip, runs/perf_ab_r04.jsonl); "sort" = occupancy gather
    # + one ascending [R, D] i32 sort; "scatter" = occupancy gather +
    # cumsum rank + unique-destination scatter. Identical results.
    slot_select: str = "merge"
    # Final K-of-candidates selection on the prebuilt-table path. The JAX
    # package offers four formulations with identical numerics ("sort",
    # "argmin", "topk", "pallas"); the port has one: "pallas" names the
    # fused distance + selection kernel, which on CUDA is
    # csrc/knn_select.cu (ops/knn_select.py).
    knn_select: str = "sort"
    # Payload-gather BACKWARD formulation (models/points.gather_points):
    # "scatter" = XLA scatter-add of the [M, 13+F] cotangent rows (default);
    # "sort" = argsort cotangents by point id + sorted segment_sum — one
    # linear pass with no duplicate-index collisions for XLA to serialize.
    # Same gradient up to f32 summation order.
    gather_bwd: str = "scatter"
    # Precompute per-voxel neighbor candidate lists at grid build
    # (ops/grid.py): the query then reads ONE contiguous [Q*P, 3] row per
    # shading point instead of Q small bucket gathers — ~6x faster query on
    # TPU at the cost of max_d * Q*P * 16 bytes of HBM. Turn off for very
    # large grids.
    prebuild_neighbors: bool = False
    # dilated-voxel table capacity for the prebuilt lists (0 -> 4 * max_o).
    # Size to (dilation factor) x (actual occupied voxels): ~3-5x for
    # contiguous surfaces, up to query_size volume (27x) for sparse clouds.
    max_d: int = 0
    # Static-capacity valid-sample compaction for the decode (the TPU
    # equivalent of the reference's dynamic boolean compaction,
    # point_aggregators.py:522-534 `pnt_mask_flat` indexing): > 0 routes the
    # aggregator over only the first `decode_capacity * R * SR` valid sample
    # slots (stable order) and scatters results back; every [R*SR*K]-scale
    # gather/PE/MLP/scatter then costs capacity x instead of 1 x. Typical
    # object-centric batches are 5-25% valid, so 0.25-0.5 is lossless in
    # practice; overflow (valid slots beyond capacity) renders as background
    # and is reported in RenderOutput.decode_dropped. 0 = dense decode.
    decode_capacity: float = 0.0

    @property
    def scaled_vsize(self) -> Tuple[float, float, float]:
        return tuple(v * s for v, s in zip(self.vsize, self.vscale))

    @property
    def radius_limit(self) -> float:
        return self.radius_limit_scale * max(self.vsize[0], self.vsize[1])

    def grid_bounds(self):
        """Static grid bounds: AABB padded by kernel_size/2 scaled voxels.

        reference: query_point_indices_worldcoords.py:58-75 (ranges are
        intersected with the point-cloud AABB at runtime there; we keep the
        configured AABB so that shapes stay static — conservative superset).
        """
        svs = self.scaled_vsize
        lo = tuple(self.ranges[i] - svs[i] * self.kernel_size[i] / 2 for i in range(3))
        hi = tuple(self.ranges[3 + i] + svs[i] * self.kernel_size[i] / 2 for i in range(3))
        vdim = tuple(int(-(-((hi[i] - lo[i]) / self.vsize[i]) // self.vscale[i])) for i in range(3))
        return lo, hi, vdim


@dataclass(frozen=True)
class AggregatorConfig:
    """Point aggregation + shading MLP config.

    reference: models/aggregators/point_aggregators.py:14-217 flag registry;
    defaults follow dev_scripts/w_n360/lego.sh:42-105.
    """
    agg_distance_kernel: str = "linear"     # linear|quadric|avg|numlinear|numquadric|trilinear
    agg_dist_pers: int = 20                 # dists mode (reference :750-798)
    agg_intrp_order: int = 2                # decode-then-interp with per-point alpha
    agg_axis_weight: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    agg_weight_norm: int = 1
    apply_pnt_mask: int = 1
    point_features_dim: int = 32
    point_color_mode: int = 1               # color fed to block3
    point_dir_mode: int = 1                 # dir fed to block3
    point_conf_mode: int = 1                # conf multiplies weights
    shading_feature_mlp_layer1: int = 2
    shading_feature_mlp_layer2: int = 0
    shading_feature_mlp_layer3: int = 2
    shading_feature_num: int = 256
    shading_alpha_mlp_layer: int = 1
    shading_color_mlp_layer: int = 4
    shading_color_channel_num: int = 3      # 3 = canonical RGB (reference _ori.py); 128 = fork feature render
    num_pos_freqs: int = 10
    num_viewdir_freqs: int = 4
    num_feat_freqs: int = 3
    dist_xyz_freq: int = 5
    dist_xyz_deno: float = 0.0
    act_type: str = "LeakyReLU"             # reference lego.sh:65
    act_super: int = 1                      # softplus(x-1) density / widened sigmoid color
    agg_feat_xyz_mode: str = "None"
    agg_alpha_xyz_mode: str = "None"
    agg_color_xyz_mode: str = "None"
    sh_degree: int = 4
    sh_act: str = "sigmoid"          # sh_intrp activation (ref :444-449)
    sh_dist_func: str = "sh_linear"  # sh_linear | sh_quadric (ref :452-457)
    weight_feat_dim: int = 8
    weight_xyz_freq: int = 2
    fused_decode: bool = False   # fused PE->MLP->alpha->K-reduce decode
                                 # (ops/fused_decode.py, csrc/fused_decode.cu);
                                 # requires the fused_decode_supported envelope
    fused_tile: int = 2048       # rows per fwd grid step (pallas_decode)
    fused_tile_bwd: int = 1024   # rows per bwd grid step

    @property
    def dist_dim(self) -> int:
        # reference: point_aggregators.py:243
        if self.agg_dist_pers > 9:
            return 4 if self.agg_dist_pers == 30 else 6
        return 3


@dataclass(frozen=True)
class RenderConfig:
    """Ray-march / render-function config (reference: diff_render_func.py:8-33,
    base_rendering_model.py:415-448, lego.sh:95-105)."""
    which_ray_generation: str = "near_far_linear"
    which_render_func: str = "radiance"
    which_blend_func: str = "alpha"
    which_tonemap_func: str = "off"
    raydist_mode_unit: int = 1
    fused_march: bool = False    # route the compositor through the fused
                                 # single-pass kernel (ops/fused_march.py,
                                 # csrc/fused_march.cu); requires radiance
                                 # render + alpha blend
    near_plane: float = 2.0
    far_plane: float = 6.0
    bg_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    train_jitter: float = 0.3    # ray-sample jitter fraction during training
                                 # reference: query_point_indices_worldcoords.py:91-94
    fine_sample_num: int = 0     # >0: hierarchical second pass — importance-
                                 # resample shading locations from the coarse
                                 # blend weights (refine_ray_generation,
                                 # diff_ray_marching.py:396-433) and render
                                 # `fine_raycolor` with the same decoder
    ray_middle: float = 2.0      # near_middle_far split point (:142-198)
    ray_middle_split: float = 0.6
    # --- proposal-NeRF hybrid (fork --proposal_nerf; the reference's engine
    # was never committed upstream — redesigned TPU-native in
    # models/nerf_branch.py + renderer._hybrid_march): a global PE-MLP
    # radiance field contributes nerf_importance extra samples per ray
    # (drawn from a coarse NeRF proposal), z-merged with the point samples
    # and marched once. 0 disables.
    nerf_importance: int = 0
    nerf_coarse_samples: int = 64
    nerf_hidden: int = 128
    nerf_layers: int = 4
    nerf_pe_xyz: int = 10
    nerf_pe_dir: int = 4


@dataclass(frozen=True)
class PointsConfig:
    """Neural point cloud attribute/grad config
    (reference: models/neural_points/neural_points.py:16-230, lego.sh:12-16)."""
    feature_init_method: str = "rand"
    xyz_grad: bool = False
    feat_grad: bool = True
    conf_grad: bool = True
    color_grad: bool = True
    dir_grad: bool = True
    default_conf: float = 0.15
    vox_res: int = 320           # initial voxel-downsample resolution


@dataclass(frozen=True)
class LossConfig:
    """Loss registry config (reference: base_rendering_model.py:29-130,533-664,
    lego.sh:146-154)."""
    color_loss_items: Tuple[str, ...] = (
        "ray_masked_coarse_raycolor", "ray_miss_coarse_raycolor", "coarse_raycolor")
    color_loss_weights: Tuple[float, ...] = (1.0, 0.0, 0.0)
    zero_one_loss_items: Tuple[str, ...] = ("conf_coefficient",)
    zero_one_loss_weights: Tuple[float, ...] = (0.0001,)
    sparse_loss_weight: float = 0.0
    zero_epsilon: float = 1e-3
    # depth supervision (ray_depth_masked_* dispatch,
    # base_rendering_model.py:565-571); item name 'coarse_depth'
    depth_loss_items: Tuple[str, ...] = ()
    depth_loss_weights: Tuple[float, ...] = ()
    # background supervision on coarse_is_background vs the GT-derived
    # background mask (bg_loss_items, base_rendering_model.py:96-104)
    bg_loss_items: Tuple[str, ...] = ()
    bg_loss_weights: Tuple[float, ...] = ()
    bg_color_match_eps: float = 2e-3  # ||gt - bg|| threshold for the bg mask


@dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule (reference: lego.sh:110-143,
    options/train_options.py)."""
    lr: float = 5e-4
    plr: float = 2e-3            # point-attribute lr (reference --plr)
    lr_policy: str = "iter_exponential_decay"
    lr_decay_iters: int = 1000000
    lr_decay_exp: float = 0.1
    batch_size: int = 1
    random_sample: str = "random"
    random_sample_size: int = 60          # rays/iter = size^2
    maximum_step: int = 200000
    alter_step: int = 0
    prune_iter: int = 10001
    prune_max_iter: int = 130000
    prune_thresh: float = 0.1
    prob_freq: int = 10001
    prob_num_step: int = 20
    prob_thresh: float = 0.7
    prob_mul: float = 0.4
    save_iter_freq: int = 10000
    test_freq: int = 10000
    print_freq: int = 40
    seed: int = 0
    # MXU compute dtype for the aggregator MLPs ("f32" | "bf16"). Params,
    # compositing, and losses stay f32; only the big masked matmuls run in
    # bf16 (TPU-native mixed precision — no reference analog).
    compute_dtype: str = "f32"
    # --- per-point gradient-starvation levers (no reference analog; the
    # reference's global prune_thresh conflates "misplaced" with
    # "under-trained" points — PERF.md cluster failure analysis) -----------
    # Max per-point UPDATE boost for under-hit payloads: points whose EMA
    # neighbor-hit rate is below the active mean get their Adam updates
    # (features/color/dirs/conf — not xyz) scaled by
    # clip((mean/ema)**hit_boost_pow, 1, hit_lr_boost). <=1 disables.
    hit_lr_boost: float = 0.0
    hit_boost_pow: float = 0.5
    # per-step EMA decay of the per-point hit counters
    hit_ema_decay: float = 0.999
    # prune eligibility floor: points with fewer than this many CUMULATIVE
    # neighbor hits are exempt from confidence pruning (under-trained, not
    # misplaced). 0 restores reference behavior (prune on conf alone).
    prune_min_hits: float = 0.0
    # --- gradient-driven point splitting (densification; no reference
    # analog — 3DGS-style: points whose payload-gradient EMA stays large
    # relative to how often they are sampled mark under-reconstructed
    # regions, e.g. thin geometry covered by too few points) --------------
    # cadence in steps (0 disables); splits run inside the prune window
    # (step <= prune_max_iter), like prune/grow
    split_iter: int = 0
    # max points cloned per split event
    split_top: int = 512
    # offspring jitter radius in voxel-size multiples, applied TANGENTIALLY
    # to the parent's dir (surface normal) so thin sheets densify in-plane
    split_jitter: float = 0.5
    # Per-point hit-counter/grad-EMA tracking. The counter scatter-add is a
    # collision-heavy [R*SR*K] -> [capacity] update — the exact pattern the
    # gather_bwd="sort" note documents as serialized on TPU — so it must
    # not ride the hot path when nothing reads it. None = auto: track iff a
    # consumer lever is on (hit_lr_boost > 1, prune_min_hits > 0,
    # split_iter > 0). True forces tracking (hits_pct calibration runs),
    # False forces it off. jit_canonical resolves auto BEFORE zeroing the
    # schedule-only fields it depends on.
    track_hits: Optional[bool] = None
    # proposal-NeRF point creation (reference --nerf_create_points,
    # multiseq_model.py:413-417): probe frames turn missed rays whose
    # radiance-field blend mass exceeds prob_thresh into grow candidates at
    # the field's expected depth. Requires render.nerf_importance > 0 and
    # 3-channel color.
    nerf_create_points: bool = False


@dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout. Replaces DataParallel/DDP-NCCL
    (reference: neural_points_volumetric_model.py:173-176, train_ddp.py:632-669)
    with jax.sharding over a Mesh: rays are data-parallel over `dp`, the point
    cloud can be sharded over `mp` with halo all-gathers."""
    dp: int = 1                  # ray/data parallel axis size
    mp: int = 1                  # point-shard axis size
    remat: bool = False          # jax.checkpoint the aggregate+march core:
                                 # recompute activations in backward instead
                                 # of holding [R*SR*K, hidden] residuals in HBM


@dataclass(frozen=True)
class DataConfig:
    """Dataset selection + ray sampling (reference: data/__init__.py:9-87,
    data/nerf_synth360_ft_dataset.py)."""
    dataset_name: str = "nerf_synth360_ft"
    data_root: str = ""
    scan: str = "lego"
    img_wh: Tuple[int, int] = (800, 800)
    dir_norm: int = 0
    split: str = "train"


@dataclass(frozen=True)
class PointNeRFConfig:
    query: QueryConfig = field(default_factory=QueryConfig)
    agg: AggregatorConfig = field(default_factory=AggregatorConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    points: PointsConfig = field(default_factory=PointsConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    data: DataConfig = field(default_factory=DataConfig)

    def replace(self, **kw) -> "PointNeRFConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=list)

    @staticmethod
    def from_json(s: str) -> "PointNeRFConfig":
        d = json.loads(s)

        def build(cls, dd):
            kw = {}
            for f in dataclasses.fields(cls):
                if f.name not in dd:
                    continue
                v = dd[f.name]
                if dataclasses.is_dataclass(f.type) if isinstance(f.type, type) else False:
                    v = build(f.type, v)
                elif isinstance(v, list):
                    v = tuple(v)
                kw[f.name] = v
            return cls(**kw)

        sub = {
            "query": QueryConfig, "agg": AggregatorConfig, "render": RenderConfig,
            "points": PointsConfig, "loss": LossConfig, "train": TrainConfig,
            "parallel": ParallelConfig, "data": DataConfig,
        }
        kw = {k: build(c, d[k]) for k, c in sub.items() if k in d}
        return PointNeRFConfig(**kw)


def effective_ray_generator(cfg: PointNeRFConfig) -> str:
    """Resolve the ray-generator registry key: an explicit non-default
    which_ray_generation wins; otherwise QueryConfig.inverse=1 selects
    disparity spacing (the reference keys generation off `inverse` inside
    the querier, query_point_indices.py:118-129)."""
    name = cfg.render.which_ray_generation
    if name and name != "near_far_linear":
        return name
    return ("near_far_disparity_linear" if cfg.query.inverse > 0
            else "near_far_linear")


def generator_kwargs(cfg: PointNeRFConfig) -> Tuple:
    """Hashable extra kwargs for the resolved ray generator (near_middle_far
    takes the split parameters; every other generator takes none)."""
    if effective_ray_generator(cfg) == "near_middle_far":
        return (("middle", cfg.render.ray_middle),
                ("middle_split", cfg.render.ray_middle_split))
    return ()


def hits_tracked(cfg: PointNeRFConfig) -> bool:
    """Resolve TrainConfig.track_hits (None = auto: on iff a consumer
    lever is enabled)."""
    t = cfg.train
    if t.track_hits is not None:
        return t.track_hits
    return (t.hit_lr_boost > 1.0 or t.prune_min_hits > 0
            or t.split_iter > 0)


def ranges_from_cloud(xyz, pad_frac: float = 0.05
                      ) -> Tuple[float, float, float, float, float, float]:
    """Scene AABB from a point cloud [N, 3] (numpy), padded by `pad_frac`
    of its extent plus 1e-3 on each side. Call once at scene setup and
    keep it in QueryConfig.ranges: the grid's shape follows from it."""
    lo = np.asarray(xyz).min(axis=0)
    hi = np.asarray(xyz).max(axis=0)
    pad = (hi - lo) * pad_frac + 1e-3
    lo, hi = lo - pad, hi + pad
    return (float(lo[0]), float(lo[1]), float(lo[2]),
            float(hi[0]), float(hi[1]), float(hi[2]))


def scene_config(xyz, vox_res: int = 320, K: int = 8, SR: int = 80,
                 z_depth_dim: int = 400, near: float = 2.0, far: float = 6.0
                 ) -> PointNeRFConfig:
    """A per-scene config sized from an init cloud: ranges from its padded
    AABB, the voxel size its longest side / vox_res."""
    r = ranges_from_cloud(xyz)
    span = max(r[3] - r[0], r[4] - r[1], r[5] - r[2])
    v = span / vox_res
    return PointNeRFConfig(
        query=QueryConfig(vsize=(v, v, v), K=K, SR=SR,
                          z_depth_dim=z_depth_dim, ranges=r),
        render=RenderConfig(near_plane=near, far_plane=far))


def lego_config() -> PointNeRFConfig:
    """The canonical lego per-scene config (dev_scripts/w_n360/lego.sh)."""
    return PointNeRFConfig()


def bench_config() -> PointNeRFConfig:
    """Reference-budget benchmark config on the synthetic sphere scene:
    the full lego query/shading budget (D=400 -> SR=80 -> K=8, 3600 rays/iter,
    dev_scripts/w_n360/lego.sh:51-66,110-112) with an AABB sized for the
    procedural sphere (data/synthetic.py). bf16 MXU compute + remat."""
    return PointNeRFConfig(
        query=QueryConfig(
            vsize=(0.008, 0.008, 0.008), vscale=(2.0, 2.0, 2.0),
            max_o=32768, P=9, K=8, SR=80, z_depth_dim=400,
            ranges=(-0.8, -0.8, -0.8, 0.8, 0.8, 0.8), knn_chunk=294912,
            prebuild_neighbors=True, max_d=131072, shell_layered=False,
            decode_capacity=0.125),
        render=RenderConfig(near_plane=2.0, far_plane=4.5),
        train=TrainConfig(compute_dtype="bf16"),
        parallel=ParallelConfig(remat=False),
    )


def tiny_test_config() -> PointNeRFConfig:
    """A CPU-runnable tiny config for unit/golden tests
    (BASELINE.json:7 — lego 400x400, K=8)."""
    return PointNeRFConfig(
        query=QueryConfig(
            vsize=(0.08, 0.08, 0.08), vscale=(2.0, 2.0, 2.0),
            max_o=4096, P=6, K=4, SR=16, z_depth_dim=64,
            ranges=(-1.0, -1.0, -1.0, 1.0, 1.0, 1.0), knn_chunk=4096),
        agg=AggregatorConfig(
            point_features_dim=8, shading_feature_num=32,
            num_feat_freqs=2, dist_xyz_freq=3,
            num_pos_freqs=4, num_viewdir_freqs=2),
        train=TrainConfig(random_sample_size=8),
    )
