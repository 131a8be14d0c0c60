"""Import and export a reference per-scene checkpoint
(`{iter}_net_ray_marching.pth`).

Counterpart of `pointnerf_tpu/train/torch_import.py`
(`import_reference_scene`, `export_reference_scene`, `torch_dict_to_npz`,
`load_npz_checkpoint`). The reference saves one torch state_dict per scene
holding both the neural point cloud and the aggregator's MLP weights:

  neural_points.xyz              [N, 3]
  neural_points.points_embeding  [1, N, F]
  neural_points.points_conf      [1, N, 1]
  neural_points.points_dir       [1, N, 3]
  neural_points.points_color     [1, N, 3]
  neural_points.Rw2c             [3, 3] (or per point [N, 3, 3])
  aggregator.block1.{i}.weight/.bias      (nn.Sequential Linear +
  aggregator.block3.{i}.weight/.bias       activation pairs)
  aggregator.alpha_branch.{i}.weight/.bias
  aggregator.color_branch.{i}.weight/.bias

The importer maps it onto the port's (PointCloud, PointCloudStatic,
aggregator params); a leading "module." (DataParallel) is dropped. The
exporter writes the dict back with CPU tensors, which `torch.save` turns
into a `.pth` that the reference's load_networks(strict=False) accepts. A
composite's per-point Rw2c is exported for its live points only, so the
export of a composite imports again.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..config import PointNeRFConfig
from ..models.aggregator import init_aggregator_params
from ..models.points import PointCloud, PointCloudStatic, make_point_cloud


def _to_numpy(v) -> np.ndarray:
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _strip_prefix(sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Normalize keys: drop a DataParallel "module." prefix, numpy-ify."""
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = _to_numpy(v)
    return out


# reference nn.Sequential attribute -> the port's param-dict key
_BLOCK_MAP = (
    ("aggregator.block1", "block1"),
    ("aggregator.block2", "block2"),
    ("aggregator.block3", "block3"),
    ("aggregator.alpha_branch", "alpha"),
    ("aggregator.color_branch", "color"),
    ("aggregator.feat_weight_mlp", "feat_weight"),
)


def _collect_mlp(sd: Dict[str, np.ndarray], prefix: str):
    """Gather `{prefix}.{i}.weight/.bias` Linear pairs in Sequential order.
    Activation modules own no parameters, so the parameterized indices are
    exactly the Linears."""
    idxs = sorted({int(k[len(prefix) + 1:].split(".")[0])
                   for k in sd if k.startswith(prefix + ".")})
    layers = []
    for i in idxs:
        w = sd.get(f"{prefix}.{i}.weight")
        b = sd.get(f"{prefix}.{i}.bias")
        if w is None:
            continue
        # torch Linear.weight is [out, in]; the port's is [in, out]
        layers.append({"w": np.ascontiguousarray(w.T.astype(np.float32)),
                       "b": (b if b is not None
                             else np.zeros(w.shape[0])).astype(np.float32)})
    return layers


def _shapes(tree):
    return {k: [{n: tuple(v.shape) for n, v in layer.items()}
                for layer in layers] for k, layers in tree.items()}


def import_reference_scene(state_dict, cfg: PointNeRFConfig,
                           capacity: Optional[int] = None,
                           generator: Optional[torch.Generator] = None,
                           device: DeviceLike = None
                           ) -> Tuple[PointCloud, PointCloudStatic, Dict]:
    """A reference `*_net_ray_marching.pth` state_dict (or a path to one)
    -> (PointCloud, PointCloudStatic, aggregator params) on `device`.

    The aggregator parameters are checked shape for shape against
    `init_aggregator_params(cfg.agg)`: a mismatch means cfg.agg does not
    describe the checkpoint's architecture, and raises with both shapes
    named. A per-point Rw2c [N, 3, 3] is padded to the capacity with
    identities. `generator` is make_point_cloud's (the features come from
    the checkpoint, so it draws nothing)."""
    dev = resolve_device(device)
    if isinstance(state_dict, (str, bytes)):
        state_dict = torch.load(state_dict, map_location="cpu",
                                weights_only=True)
    sd = _strip_prefix(state_dict)

    required = ["neural_points.xyz", "neural_points.points_embeding"]
    missing = [k for k in required if k not in sd]
    if missing:
        raise KeyError(f"not a reference scene checkpoint: missing {missing}")

    xyz = sd["neural_points.xyz"].reshape(-1, 3).astype(np.float32)
    n = xyz.shape[0]

    def pts(name, width, fill):
        v = sd.get(f"neural_points.{name}")
        if v is None:
            return np.full((n, width), fill, np.float32)
        return v.reshape(n, width).astype(np.float32)

    feats = sd["neural_points.points_embeding"].reshape(n, -1)
    if feats.shape[1] != cfg.agg.point_features_dim:
        raise ValueError(
            f"checkpoint feature dim {feats.shape[1]} != "
            f"cfg.agg.point_features_dim {cfg.agg.point_features_dim}")
    pc, st = make_point_cloud(
        xyz, generator if generator is not None
        else torch.Generator().manual_seed(0), cfg.points,
        cfg.agg.point_features_dim, features=feats.astype(np.float32),
        conf=pts("points_conf", 1, cfg.points.default_conf),
        color=pts("points_color", 3, 0.0),
        dirs=pts("points_dir", 3, 0.0), capacity=capacity, device=dev)

    rw2c = sd.get("neural_points.Rw2c")
    if rw2c is not None:
        rw2c = rw2c.astype(np.float32)
        if rw2c.ndim == 3:  # per-point rotations (editing composites)
            full = np.broadcast_to(np.eye(3, dtype=np.float32),
                                   (pc.capacity, 3, 3)).copy()
            full[:n] = rw2c
            rw2c = full
        st = st._replace(Rw2c=torch.from_numpy(rw2c).to(dev))

    params = {}
    for t_prefix, ours in _BLOCK_MAP:
        layers = _collect_mlp(sd, t_prefix)
        if layers:
            params[ours] = [{"w": torch.from_numpy(lyr["w"]).to(dev),
                             "b": torch.from_numpy(lyr["b"]).to(dev)}
                            for lyr in layers]

    want = _shapes(init_aggregator_params(
        cfg.agg, torch.Generator().manual_seed(0), device="cpu"))
    got = _shapes(params)
    if got != want:
        raise ValueError(
            "aggregator architecture mismatch between the checkpoint and "
            f"cfg.agg:\n  checkpoint: {got}\n  config:     {want}")
    return pc, st, params


def export_reference_scene(pc: PointCloud, st: PointCloudStatic,
                           agg_params: Dict, num_active: Optional[int] = None
                           ) -> Dict[str, torch.Tensor]:
    """A reference-format `net_ray_marching` state_dict of CPU tensors (pass
    it to torch.save for a .pth). The inverse of import_reference_scene."""
    n = int(num_active if num_active is not None else st.num_active)

    def t(x):
        return x.detach().to("cpu", torch.float32).contiguous()
    rw2c = t(st.Rw2c)
    sd: Dict[str, torch.Tensor] = {
        "neural_points.xyz": t(pc.xyz[:n]),
        "neural_points.points_embeding": t(pc.features[:n])[None],
        "neural_points.points_conf": t(pc.conf[:n])[None],
        "neural_points.points_color": t(pc.color[:n])[None],
        "neural_points.points_dir": t(pc.dirs[:n])[None],
        "neural_points.Rw2c": rw2c[:n] if rw2c.dim() == 3 else rw2c,
    }
    for t_prefix, ours in _BLOCK_MAP:
        # Linears at even Sequential indices (Linear + activation pairs;
        # the last Linear of alpha / color sits right after the last pair)
        for i, layer in enumerate(agg_params.get(ours) or ()):
            sd[f"{t_prefix}.{2 * i}.weight"] = t(layer["w"]).T.contiguous()
            sd[f"{t_prefix}.{2 * i}.bias"] = t(layer["b"])
    return sd


def torch_dict_to_npz(pth_path: str, npz_path: str):
    """A reference .pth as an .npz of numpy arrays (keys without the
    "module." prefix), which `load_npz_checkpoint` reads back."""
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    np.savez(npz_path, **_strip_prefix(sd))


def load_npz_checkpoint(npz_path: str) -> Dict[str, np.ndarray]:
    with np.load(npz_path) as z:
        return {k: z[k] for k in z.files}
