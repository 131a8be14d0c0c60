"""Per-scene experiment presets: the reference's per-scene launch scripts
as typed configs.

Counterpart of `pointnerf_tpu/presets.py` (`SCENE_PRESETS`, `scene_preset`,
`preset_mvs_init_kwargs`) with the same values. Each entry carries what
varies across the reference scripts (dev_scripts/w_n360/*.sh,
w_scannet_etf/*.sh, w_tt_ft/*.sh): scene AABB, voxel size, occupancy caps
(max_o, P), shading budget (SR), prune/grow schedule, ray batch, near/far
and the MVS-init thresholds; everything else keeps the shared defaults. A
negative prune_iter / prob_freq / prob_thresh disables that mechanism.

Use: `cfg = scene_preset("nerf_synth/chair")`.
"""
from __future__ import annotations

from typing import Dict

from .config import (AggregatorConfig, DataConfig, PointNeRFConfig,
                     PointsConfig, QueryConfig, RenderConfig, TrainConfig)

# (dataset, scan, ranges, vsize, max_o, P, SR, prune_iter, prune_max_iter,
#  prob_freq, prob_thresh, random_sample_size, near, far, vox_res,
#  default_conf, zero_one_w, depth_conf_thresh, geo_cnsst_num, img_wh)
_N360 = "nerf_synth360_ft"
_SCENES: Dict[str, Dict] = {
    # --- NeRF-Synthetic 360 (dev_scripts/w_n360/<scan>.sh) ------------------
    "nerf_synth/lego": dict(
        dataset=_N360, scan="lego",
        ranges=(-0.638, -1.141, -0.346, 0.634, 1.149, 1.141),
        max_o=830000, P=9, prune_iter=10001, prune_max_iter=130000,
        prob_freq=10001, geo_cnsst_num=0),
    "nerf_synth/chair": dict(
        dataset=_N360, scan="chair",
        ranges=(-0.721, -0.695, -0.995, 0.658, 0.706, 1.050),
        max_o=410000, P=12, prune_iter=-10001, prune_max_iter=200000,
        prob_freq=10001, geo_cnsst_num=2),
    "nerf_synth/drums": dict(
        dataset=_N360, scan="drums",
        ranges=(-1.126, -0.746, -0.492, 1.122, 0.962, 0.939),
        max_o=400000, P=10, prune_iter=-10001, prune_max_iter=-130000,
        prob_freq=10001, geo_cnsst_num=0),
    "nerf_synth/ficus": dict(
        dataset=_N360, scan="ficus",
        ranges=(-0.377, -0.858, -1.034, 0.555, 0.578, 1.141),
        max_o=290000, P=12, prune_iter=10001, prune_max_iter=0,
        prob_freq=-10001, prob_thresh=-0.7, geo_cnsst_num=0),
    "nerf_synth/hotdog": dict(
        dataset=_N360, scan="hotdog",
        ranges=(-1.198, -1.286, -0.190, 1.198, 1.110, 0.312),
        max_o=1000000, P=9, prune_iter=10001, prune_max_iter=130000,
        prob_freq=10001, geo_cnsst_num=5),
    "nerf_synth/materials": dict(
        dataset=_N360, scan="materials",
        ranges=(-1.123, -0.759, -0.232, 1.072, 0.986, 0.200),
        max_o=930000, P=9, prune_iter=-10001, prune_max_iter=130000,
        prob_freq=10001, geo_cnsst_num=0),
    "nerf_synth/mic": dict(
        dataset=_N360, scan="mic",
        ranges=(-1.252, -0.910, -0.742, 0.767, 1.082, 1.151),
        max_o=300000, P=9, prune_iter=-10001, prune_max_iter=200000,
        prob_freq=-10001, random_sample_size=110, geo_cnsst_num=0),
    "nerf_synth/ship": dict(
        dataset=_N360, scan="ship",
        ranges=(-1.277, -1.300, -0.550, 1.371, 1.349, 0.729),
        max_o=1500000, P=10, prune_iter=10001, prune_max_iter=200000,
        prob_freq=10001, prob_thresh=0.5, geo_cnsst_num=4),
    # --- ScanNet (dev_scripts/w_scannet_etf/<scene>.sh) ---------------------
    # scene101.sh ships without schedule lines (prune/prob unset -> off)
    "scannet/scene101": dict(
        dataset="scannet_ft", scan="scene0101_04",
        ranges=(-10.0, -10.0, -10.0, 10.0, 10.0, 10.0),
        vsize=(0.008, 0.008, 0.008), max_o=2000000, P=30, SR=24,
        prune_iter=-1, prob_freq=-1, random_sample_size=56,
        near=0.1, far=8.0, geo_cnsst_num=0),
    "scannet/scene241": dict(
        dataset="scannet_ft", scan="scene0241_01",
        ranges=(-10.0, -10.0, -10.0, 10.0, 10.0, 10.0),
        vsize=(0.008, 0.008, 0.008), max_o=610000, P=26, SR=24,
        prune_iter=-1, prob_freq=10000, random_sample_size=56,
        near=0.1, far=8.0, vox_res=900, default_conf=-1.0,
        geo_cnsst_num=0),
    # --- Tanks & Temples / NSVF (dev_scripts/w_tt_ft/<scan>.sh) -------------
    "tt/barn": dict(
        dataset="tt_ft", scan="Barn",
        ranges=(-2.05965, -0.48064, -2.23660, 1.78036, 0.6094, 1.28341),
        vsize=(0.003, 0.003, 0.003), max_o=1500000, P=11, SR=40,
        prune_iter=10001, prune_max_iter=130000, prob_freq=10001,
        random_sample_size=48, near=0.0, far=4.5, vox_res=640,
        geo_cnsst_num=2, img_wh=(1088, 640)),
    "tt/caterpillar": dict(
        dataset="tt_ft", scan="Caterpillar",
        ranges=(-1.3345, -0.8172, -0.9727, 0.9255, 0.7428, 1.3273),
        vsize=(0.002, 0.002, 0.002), max_o=1800000, P=10, SR=40,
        prune_iter=10001, prune_max_iter=100000, prob_freq=10001,
        random_sample_size=56, near=0.0, far=3.0, vox_res=640,
        geo_cnsst_num=3, img_wh=(1088, 640)),
    "tt/family": dict(
        dataset="tt_ft", scan="Family",
        ranges=(-0.31397, -0.20539, -0.33925, 0.26604, 0.37462, 0.24076),
        vsize=(0.001, 0.001, 0.001), max_o=800000, P=32, SR=40,
        prune_iter=10001, prune_max_iter=130000, prob_freq=10001,
        random_sample_size=68, near=0.0, far=1.0, vox_res=640,
        geo_cnsst_num=4, img_wh=(1088, 640)),
    "tt/ignatius": dict(
        dataset="tt_ft", scan="Ignatius",
        ranges=(-0.4767, -0.5928, -0.5274, 0.5833, 0.7872, 0.5326),
        vsize=(0.002, 0.002, 0.002), max_o=1050000, P=18, SR=40,
        prune_iter=10001, prune_max_iter=130000, prob_freq=10001,
        random_sample_size=56, near=0.0, far=3.2, vox_res=640,
        geo_cnsst_num=0, img_wh=(1088, 640)),
    "tt/truck": dict(
        dataset="tt_ft", scan="Truck",
        ranges=(-1.125, -0.598, -1.052, 0.795, 0.203, 1.029),
        vsize=(0.002, 0.002, 0.002), max_o=1600000, P=10, SR=40,
        prune_iter=10001, prune_max_iter=100000, prob_freq=10001,
        random_sample_size=56, near=0.0, far=3.5, vox_res=640,
        default_conf=0.1, geo_cnsst_num=1, img_wh=(1088, 640)),
}

SCENE_PRESETS = tuple(sorted(_SCENES))


def scene_preset(name: str, fused_decode: bool = True,
                 compute_dtype: str = "bf16") -> PointNeRFConfig:
    """Full PointNeRFConfig for a named reference scene, with bf16 decode
    compute and the fused decode flag on by default, as in the JAX
    package."""
    if name not in _SCENES:
        raise KeyError(f"unknown preset {name!r}; have {SCENE_PRESETS}")
    s = dict(_SCENES[name])
    query = QueryConfig(
        vsize=s.get("vsize", (0.004, 0.004, 0.004)),
        max_o=s["max_o"], P=s["P"], SR=s.get("SR", 80),
        ranges=s["ranges"])
    render = RenderConfig(near_plane=s.get("near", 2.0),
                          far_plane=s.get("far", 6.0))
    train = TrainConfig(
        random_sample_size=s.get("random_sample_size", 60),
        maximum_step=200000,
        prune_iter=s.get("prune_iter", 10001),
        prune_max_iter=s.get("prune_max_iter", 130000),
        prob_freq=s.get("prob_freq", 10001),
        prob_thresh=s.get("prob_thresh", 0.7),
        compute_dtype=compute_dtype)
    points = PointsConfig(default_conf=s.get("default_conf", 0.15),
                          vox_res=s.get("vox_res", 320))
    data = DataConfig(dataset_name=s["dataset"], scan=s["scan"],
                      img_wh=s.get("img_wh", (800, 800)))
    agg = AggregatorConfig(fused_decode=fused_decode)
    return PointNeRFConfig(query=query, render=render, train=train,
                           points=points, data=data, agg=agg)


def preset_mvs_init_kwargs(name: str) -> Dict:
    """MVS point-init thresholds for train_dataset_scene(mvs_init_kwargs=...)
    (depth_conf_thresh / geo_cnsst_num lines of the dev scripts)."""
    s = _SCENES[name]
    return dict(depth_conf_thresh=s.get("depth_conf_thresh", 0.8),
                geo_cnsst_num=s.get("geo_cnsst_num", 0))
