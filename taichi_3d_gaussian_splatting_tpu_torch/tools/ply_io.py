"""Minimal PLY mesh/point I/O + surface sampling (numpy only).

Port of
``taichi_3d_gaussian_splatting_tpu/tools/ply_io.py``,
a copy that runs on the host alone (no device, no torch).

Replaces the reference tools' plyfile / trimesh dependencies
(tools/prepare_kitti.py:158-164, tools/prepare_InstantNGP_with_mesh.py:
86-88) — neither package is needed. Supports ascii and
binary_little_endian PLY with float/double/int vertex properties and
uchar-count face lists, plus Wavefront OBJ triangle meshes.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> Dict[str, dict]:
    """Returns {element_name: {prop: np.ndarray}}; face lists come back as
    an (F, max_count) int array under 'vertex_indices'."""
    with open(path, "rb") as f:
        line = f.readline().decode("ascii").strip()
        assert line == "ply", f"{path} is not a PLY file"
        fmt = None
        elements: List[Tuple[str, int, list]] = []
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                elements.append((name, int(count), []))
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    elements[-1][2].append(
                        ("list", parts[2], parts[3], parts[4]))
                else:
                    elements[-1][2].append(("scalar", parts[1], parts[2]))
            elif line == "end_header":
                break
        assert fmt in ("ascii", "binary_little_endian"), fmt

        out: Dict[str, dict] = {}
        for name, count, props in elements:
            if fmt == "ascii":
                out[name] = _read_ascii_element(f, count, props)
            else:
                out[name] = _read_binary_element(f, count, props)
        return out


def _read_ascii_element(f, count, props):
    has_list = any(p[0] == "list" for p in props)
    rows = [f.readline().decode("ascii").split() for _ in range(count)]
    data: Dict[str, np.ndarray] = {}
    if not has_list:
        arr = np.asarray(rows, np.float64)
        for i, (_, _t, pname) in enumerate(props):
            data[pname] = arr[:, i]
        return data
    # assume single list property (faces)
    lists = []
    for row in rows:
        n = int(row[0])
        lists.append([int(x) for x in row[1: 1 + n]])
    width = max(len(l) for l in lists)
    arr = np.full((count, width), -1, np.int64)
    for i, l in enumerate(lists):
        arr[i, : len(l)] = l
    data[props[0][3]] = arr
    return data


def _read_binary_element(f, count, props):
    if all(p[0] == "scalar" for p in props):
        dtype = np.dtype([(p[2], "<" + _PLY_TYPES[p[1]]) for p in props])
        raw = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype)
        return {p[2]: np.asarray(raw[p[2]]) for p in props}
    # element with a list property: read row by row
    assert len(props) == 1 and props[0][0] == "list"
    _, count_t, idx_t, pname = props[0]
    cfmt = "<" + {"uchar": "B", "uint8": "B", "int": "i",
                  "uint": "I", "int32": "i"}[count_t]
    isz = np.dtype(_PLY_TYPES[idx_t]).itemsize
    lists = []
    for _ in range(count):
        (n,) = struct.unpack(cfmt, f.read(struct.calcsize(cfmt)))
        idx = np.frombuffer(f.read(isz * n), dtype="<" + _PLY_TYPES[idx_t])
        lists.append(idx.astype(np.int64))
    width = max(len(l) for l in lists)
    arr = np.full((count, width), -1, np.int64)
    for i, l in enumerate(lists):
        arr[i, : len(l)] = l
    return {pname: arr}


def read_ply_points(path: str) -> np.ndarray:
    """(N, 3) float32 vertex positions (reference load_point_cloud,
    tools/prepare_kitti.py:158-164)."""
    v = read_ply(path)["vertex"]
    return np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)


def read_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices (V, 3), triangle faces (F, 3)) from .ply or .obj."""
    if path.lower().endswith(".obj"):
        return _read_obj(path)
    data = read_ply(path)
    verts = np.stack(
        [data["vertex"]["x"], data["vertex"]["y"], data["vertex"]["z"]],
        axis=1,
    ).astype(np.float64)
    faces_raw = data["face"]["vertex_indices"]
    faces = _triangulate(faces_raw)
    return verts, faces


def _read_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def _triangulate(faces_raw: np.ndarray) -> np.ndarray:
    tris = []
    for row in faces_raw:
        idx = row[row >= 0]
        for k in range(1, len(idx) - 1):
            tris.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(tris, np.int64)


def sample_mesh_surface(
    verts: np.ndarray, faces: np.ndarray, count: int,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Uniform area-weighted surface sampling (trimesh.sample.sample_surface
    equivalent, used by tools/prepare_InstantNGP_with_mesh.py:87)."""
    rng = rng or np.random.default_rng(0)
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    probs = areas / areas.sum()
    tri = rng.choice(len(faces), size=count, p=probs)
    u = rng.random(count)
    v = rng.random(count)
    flip = u + v > 1.0
    u[flip] = 1.0 - u[flip]
    v[flip] = 1.0 - v[flip]
    pts = a[tri] + u[:, None] * (b[tri] - a[tri]) + v[:, None] * (c[tri] - a[tri])
    return pts.astype(np.float32)
