"""The port package stands alone: importing it pulls in neither JAX nor the
JAX package, nor an image library (imageio, cv2, PIL: the card host has
none; checked in a subprocess, since this process has imported them
already), every kernel module imports without nvcc or a card, entry points
default to the card and raise without one, and CPU tensors take the plain
versions without a build."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "pointnerf_tpu_torch", "pointnerf_tpu_torch.config",
    "pointnerf_tpu_torch.camera", "pointnerf_tpu_torch.convert",
    "pointnerf_tpu_torch.data.synthetic", "pointnerf_tpu_torch.models.points",
    "pointnerf_tpu_torch.models.aggregator",
    "pointnerf_tpu_torch.models.ray_march",
    "pointnerf_tpu_torch.models.renderer", "pointnerf_tpu_torch.ops.grid",
    "pointnerf_tpu_torch.ops.pe", "pointnerf_tpu_torch.ops.query",
    "pointnerf_tpu_torch.ops.knn_select",
    "pointnerf_tpu_torch.ops.fused_decode",
    "pointnerf_tpu_torch.ops.fused_march", "pointnerf_tpu_torch.ops._build",
    "pointnerf_tpu_torch.train.step", "pointnerf_tpu_torch.train.optim",
    "pointnerf_tpu_torch.models.losses", "pointnerf_tpu_torch.utils.metrics",
    "pointnerf_tpu_torch.utils.visualizer",
    "pointnerf_tpu_torch.train.sampler", "pointnerf_tpu_torch.train.grow",
    "pointnerf_tpu_torch.train.checkpoint",
    "pointnerf_tpu_torch.train.driver", "pointnerf_tpu_torch.presets",
    "pointnerf_tpu_torch.eval_cli", "pointnerf_tpu_torch.data",
    "pointnerf_tpu_torch.data.ply", "pointnerf_tpu_torch.data.procedural",
    "pointnerf_tpu_torch.data.nerf_synth", "pointnerf_tpu_torch.ops.voxel",
    "pointnerf_tpu_torch.ops.sample2d", "pointnerf_tpu_torch.mvs",
    "pointnerf_tpu_torch.mvs.mvsnet", "pointnerf_tpu_torch.mvs.filter",
    "pointnerf_tpu_torch.mvs.points_init",
    "pointnerf_tpu_torch.mvs.torch_import",
    "pointnerf_tpu_torch.mvs.masking", "pointnerf_tpu_torch.mvs.mvsnerf",
    "pointnerf_tpu_torch.train.feedforward",
    "pointnerf_tpu_torch.data.dtu", "pointnerf_tpu_torch.data.dtu_ft",
    "pointnerf_tpu_torch.models.neural_render",
    "pointnerf_tpu_torch.train.neural2d",
    "pointnerf_tpu_torch.models.registry",
    "pointnerf_tpu_torch.train.torch_import", "pointnerf_tpu_torch.edit",
    "pointnerf_tpu_torch.data.llff", "pointnerf_tpu_torch.data.scannet",
    "pointnerf_tpu_torch.utils.profiling", "pointnerf_tpu_torch.models",
    "pointnerf_tpu_torch.parallel", "pointnerf_tpu_torch.parallel.mesh",
    "pointnerf_tpu_torch.parallel.multihost",
    "pointnerf_tpu_torch.parallel.sharded",
    "pointnerf_tpu_torch.parallel.collectives",
    "pointnerf_tpu_torch.data.waymo",
]


def _run(code: str, env_extra=None):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m.startswith('jaxlib.') "
        "or m == 'pointnerf_tpu' or m.startswith('pointnerf_tpu.'))\n"
        "print('BAD', bad)\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout


@pytest.mark.parametrize("library", ["imageio", "cv2", "PIL"])
def test_import_pulls_in_no_image_library(library):
    """Neither importing the port nor reading and writing a PNG through it
    loads an image library: the card host has none."""
    code = (
        "import importlib, sys, tempfile, os\n"
        "import numpy as np\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from pointnerf_tpu_torch.utils.visualizer import read_png, write_png\n"
        "p = os.path.join(tempfile.mkdtemp(), 'x.png')\n"
        "write_png(p, np.zeros((4, 5, 3), np.uint8)); read_png(p)\n"
        f"bad = sorted(m for m in sys.modules if m == {library!r} or "
        f"m.startswith({library + '.'!r}))\n"
        "print('BAD', bad)\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout


def test_kernel_modules_import_without_nvcc():
    """No nvcc on PATH and no CUDA_HOME: importing the kernel modules and
    running their wrappers on CPU tensors must not touch the build."""
    code = (
        "import torch\n"
        "from pointnerf_tpu_torch.ops import knn_select, fused_march, "
        "fused_decode, _build\n"
        "d = torch.zeros((2, 6)); p = torch.zeros((2, 2), dtype=torch.int32)\n"
        "out = knn_select.knn_select(d, p, torch.zeros(1, dtype=torch.int32),"
        " torch.zeros((1, 3)), torch.ones(1, dtype=torch.bool), K=1, r2=0.0)\n"
        "assert out[0].tolist() == [[0]] and not _build._libs\n"
        "print('OK')\n")
    r = _run(code, {"PATH": os.path.dirname(sys.executable),
                    "CUDA_HOME": "/nonexistent"})
    assert r.returncode == 0, r.stderr
    assert "OK" in r.stdout


def test_entry_points_default_to_the_card(monkeypatch):
    from pointnerf_tpu_torch import resolve_device
    from pointnerf_tpu_torch.config import tiny_test_config
    from pointnerf_tpu_torch.convert import params_from_jax
    from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
    from pointnerf_tpu_torch.models.points import make_point_cloud
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_test_config()
    xyz = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_point_cloud(xyz, torch.Generator().manual_seed(0), cfg.points, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_aggregator_params(cfg.agg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"w": np.zeros(2)})
    assert resolve_device("cpu").type == "cpu"
    pc, _ = make_point_cloud(xyz, torch.Generator().manual_seed(0),
                             cfg.points, 8, device="cpu")
    assert pc.xyz.device.type == "cpu" and pc.capacity == 4096


def test_build_hashes_sources_into_the_build_directory():
    from pointnerf_tpu_torch.ops import _build
    for name in _build.KERNELS:
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert (_build.CSRC / f"{name}.cu").exists()
        assert "sm_90a" in " ".join(_build._flags(name))
    assert "-fmad=false" in _build._flags("knn_select")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "build/" in f.read().split()


def _world_rank():
    import torch.distributed as dist
    return dist.get_rank(), dist.get_world_size(), dist.get_backend()


def test_mesh_and_spawn_default_to_the_card(monkeypatch):
    """make_mesh, spawn and World run on the card unless given
    device="cpu", and raise without one before any process starts."""
    from pointnerf_tpu_torch.parallel import make_mesh
    from pointnerf_tpu_torch.parallel.multihost import World, spawn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn(_world_rank, 2, "gloo")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        World(2, "gloo")
    assert make_mesh(1, 1, device="cpu").device.type == "cpu"
    assert spawn(_world_rank, 2, "gloo", device="cpu") == [
        (0, 2, "gloo"), (1, 2, "gloo")]


def test_nccl_on_one_shared_card_is_refused(monkeypatch):
    """A world of ranks sharing one card with backend="nccl" raises a clear
    error before any process starts (NCCL refuses two ranks on one device)
    and does not switch to gloo on its own; the backend must be named."""
    import torch.distributed as dist
    from pointnerf_tpu_torch.parallel.multihost import (check_backend,
                                                        initialize, spawn)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="refuses two ranks on one device"):
        spawn(_world_rank, 2, "nccl")
    with pytest.raises(ValueError, match="refuses two ranks on one device"):
        check_backend("nccl", "cuda:0", 2)
    with pytest.raises(ValueError, match="CUDA devices only"):
        check_backend("nccl", "cpu", 1)
    with pytest.raises(ValueError, match="name the backend"):
        check_backend(None, "cuda", 2)
    with pytest.raises(ValueError, match="name the backend"):
        initialize("file:///nonexistent", world_size=2, rank=0)
    assert check_backend("nccl", "cuda", 1).type == "cuda"
    assert check_backend("gloo", "cuda", 2).type == "cuda"
    assert not dist.is_initialized()
