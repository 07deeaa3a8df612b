"""PLY mesh export (binary little-endian).

Counterpart: kimera_semantics_tpu/io/ply.py (write_ply, ply_bytes,
read_ply), voxblox's `outputMeshLayerAsPly` as generateMesh uses it. The
port writes with numpy only (it does not load the JAX package's native
library); the bytes are those of the JAX package.
"""

from __future__ import annotations

import numpy as np


def _vertex_dtype(with_normals: bool) -> np.dtype:
    if with_normals:
        return np.dtype([("xyz", np.float32, 3), ("nrm", np.float32, 3),
                         ("rgb", np.uint8, 3)])
    return np.dtype([("xyz", np.float32, 3), ("rgb", np.uint8, 3)])


_FACE_DTYPE = np.dtype([("n", np.uint8), ("idx", np.int32, 3)])


def write_ply(path: str, vertices: np.ndarray, colors: np.ndarray,
              triangles: np.ndarray,
              normals: np.ndarray | None = None) -> None:
    vertices = np.asarray(vertices)
    if vertices.shape[0] != np.asarray(colors).shape[0]:
        raise ValueError("vertices and colors differ in length")
    if normals is not None and np.asarray(normals).shape != vertices.shape:
        raise ValueError("normals must have the vertices' shape")
    with open(path, "wb") as f:
        f.write(ply_bytes(vertices, colors, triangles, normals))


def ply_bytes(vertices: np.ndarray, colors: np.ndarray,
              triangles: np.ndarray,
              normals: np.ndarray | None = None) -> bytes:
    """The mesh as binary-little-endian PLY bytes (write_ply's layout; the
    live HTTP mesh streamer serves them, server/viz.py)."""
    vertices = np.ascontiguousarray(vertices, dtype=np.float32)
    colors = np.ascontiguousarray(colors, dtype=np.uint8)
    triangles = np.ascontiguousarray(triangles, dtype=np.int32)
    nrm_props = ("property float nx\nproperty float ny\nproperty float nz\n"
                 if normals is not None else "")
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {len(vertices)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"{nrm_props}"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        f"element face {len(triangles)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    ).encode("ascii")
    vbuf = np.empty(len(vertices), dtype=_vertex_dtype(normals is not None))
    vbuf["xyz"] = vertices
    if normals is not None:
        vbuf["nrm"] = np.asarray(normals, dtype=np.float32)
    vbuf["rgb"] = colors
    fbuf = np.empty(len(triangles), dtype=_FACE_DTYPE)
    fbuf["n"] = 3
    fbuf["idx"] = triangles
    return header + vbuf.tobytes() + fbuf.tobytes()


def read_ply(path: str, with_normals: bool = False):
    """Reader for the files write_ply produces. Returns (vertices, colors,
    triangles) or, with `with_normals=True`, (vertices, colors, triangles,
    normals-or-None)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    nv = nf = 0
    has_normals = any(line.strip() == "property float nx" for line in header)
    for line in header:
        if line.startswith("element vertex"):
            nv = int(line.split()[-1])
        elif line.startswith("element face"):
            nf = int(line.split()[-1])
    vdt = _vertex_dtype(has_normals)
    vbuf = np.frombuffer(data, dtype=vdt, count=nv, offset=end)
    fbuf = np.frombuffer(data, dtype=_FACE_DTYPE, count=nf,
                         offset=end + nv * vdt.itemsize)
    out = (vbuf["xyz"].copy(), vbuf["rgb"].copy(), fbuf["idx"].copy())
    if with_normals:
        return out + (vbuf["nrm"].copy() if has_normals else None,)
    return out
