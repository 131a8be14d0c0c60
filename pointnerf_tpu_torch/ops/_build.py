"""Build the CUDA kernels of `csrc/` at first use and load them with ctypes.

Each `csrc/<name>.cu` is compiled by nvcc on its own into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds), for
Hopper only:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC [per-kernel flags] -o build/kernels/<name>-<hash>.so

The library name carries a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source or header rebuilds and an
unchanged one loads at once. `build()` starts one nvcc per source, all
together, and waits for them. The build directory lies in the
checkout and is listed in `.gitignore`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("knn_select", "fused_march", "fused_decode", "fused_decode_bwd",
           "fused_decode_tc", "fused_decode_bwd_tc")

# -Xptxas=-v puts each kernel's registers, shared memory and spills into
# the build log that build() returns
BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
# K1 and K2 must not contract a*b+c into one rounding: their plain PyTorch
# twins round every product and sum, and a last-bit change in a squared
# distance turns a near-tie into a different neighbor.
EXTRA_FLAGS: Dict[str, List[str]] = {
    "knn_select": ["-fmad=false"],
    "fused_march": ["-fmad=false"],
    "fused_decode": [],
    "fused_decode_bwd": [],
    "fused_decode_tc": [],
    "fused_decode_bwd_tc": [],
}

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ with the CUDA toolkit at first use")


def _flags(name: str) -> List[str]:
    return BASE_FLAGS + EXTRA_FLAGS[name]


def library_path(name: str) -> Path:
    # the shared headers of csrc/ count as part of every source
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile every named kernel that is not built yet, one nvcc process
    per source, all started together. Returns {name: {"seconds", "log",
    "cached"}}; raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            out[name] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path()] + _flags(name) + [
            "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (p, tmp, target) in procs.items():
        log, _ = p.communicate()
        out[name] = {"seconds": time.perf_counter() - t0, "log": log,
                     "cached": False}
        if p.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {p.returncode}) ---\n{log}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def stream_handle(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
