"""Minimal PLY point-cloud IO (ascii + binary_little_endian), numpy only.

Counterpart of `pointnerf_tpu/data/ply.py` (`load_ply`, `save_ply`): the
vertex element with float properties, optional colors and normals, as the
init clouds of the datasets (COLMAP's `fused.ply`, `points.ply`) hold them.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}


def load_ply(path: str) -> Dict[str, np.ndarray]:
    """Returns {'xyz': [N,3] f32, 'color': [N,3] f32 in [0,1] or None, ...}."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_vertex = 0
        props = []           # (name, dtype) for the vertex element
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                in_vertex = tok[1] == "vertex"
                if in_vertex:
                    n_vertex = int(tok[2])
            elif tok[0] == "property" and in_vertex:
                if tok[1] == "list":
                    raise ValueError("list property on vertex unsupported")
                props.append((tok[2], _DTYPES[tok[1]]))
            elif tok[0] == "end_header":
                break

        dtype = np.dtype([(n, d) for n, d in props])
        if fmt == "ascii":
            rows = []
            for _ in range(n_vertex):
                rows.append(tuple(f.readline().split()[: len(props)]))
            data = np.array(rows, dtype=dtype)
        elif fmt == "binary_little_endian":
            data = np.frombuffer(f.read(n_vertex * dtype.itemsize),
                                 dtype=dtype, count=n_vertex)
        else:
            raise ValueError(f"unsupported PLY format {fmt}")

    names = data.dtype.names
    out: Dict[str, np.ndarray] = {}
    out["xyz"] = np.stack([data["x"], data["y"], data["z"]],
                          axis=-1).astype(np.float32)
    if all(c in names for c in ("red", "green", "blue")):
        col = np.stack([data["red"], data["green"], data["blue"]], axis=-1)
        out["color"] = (col.astype(np.float32) / 255.0
                        if col.dtype == np.uint8 else col.astype(np.float32))
    if all(c in names for c in ("nx", "ny", "nz")):
        out["normal"] = np.stack([data["nx"], data["ny"], data["nz"]],
                                 axis=-1).astype(np.float32)
    return out


def save_ply(path: str, xyz: np.ndarray, color: Optional[np.ndarray] = None):
    """Binary little-endian writer (for editing/visualization exports)."""
    n = xyz.shape[0]
    props = ["property float x", "property float y", "property float z"]
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if color is not None:
        props += [f"property uchar {c}" for c in ("red", "green", "blue")]
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    rec = np.zeros(n, dtype=np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    if color is not None:
        c8 = np.clip(color * 255.0, 0, 255).astype(np.uint8) \
            if color.dtype != np.uint8 else color
        rec["red"], rec["green"], rec["blue"] = c8[:, 0], c8[:, 1], c8[:, 2]
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        f.write(("\n".join(props) + "\nend_header\n").encode())
        f.write(rec.tobytes())
