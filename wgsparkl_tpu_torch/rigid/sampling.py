"""Mesh-surface sampling for mesh colliders, on the host at scene build time
(the port's own copy of wgsparkl_tpu/rigid/sampling.py: the same arrays in
the same order).

Every triangle face is covered by a barycentric lattice and every unique
edge by a row of samples, at cell_width / sqrt(2) spacing; in 2D every
polyline segment.  Samples carry their source primitive (triangle or
segment vertex ids) and collider slot: the mesh node-CDF pass
(ops/rigid_cdf.py) projects grid nodes onto the primitive and uses the
samples only to find the nodes near it.

The C++ sampler native/sampler.cpp gives the same samples faster for large
meshes (a heightfield's thousands of triangles); it is compiled with g++ on
first use into wgsparkl_tpu_torch/_build/.  The numpy route is the oracle
(`use_native=False`) and the route taken where the compiler is missing.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

_NATIVE_SRC = pathlib.Path(__file__).resolve().parents[2] / "native" / "sampler.cpp"
_BUILD = pathlib.Path(__file__).resolve().parents[1] / "_build"


@dataclasses.dataclass
class MeshSamples:
    """SoA sample cloud of one or more mesh colliders (local space)."""

    points: np.ndarray        # [S, d] local-space sample positions
    primitives: np.ndarray    # [S, d] vertex ids of the source tri/segment
    collider_ids: np.ndarray  # [S] collider slot
    vertices: np.ndarray      # [V, d] concatenated local vertices
    normals: np.ndarray       # [S, d] primitive normal (local space)

    @property
    def count(self):
        return len(self.points)


def sample_segment(a, b, spacing):
    length = float(np.linalg.norm(b - a))
    n = max(int(np.ceil(length / spacing)), 1)
    t = (np.arange(n + 1, dtype=np.float64) / n)[:, None]
    return a[None, :] * (1 - t) + b[None, :] * t


def sample_triangle_face(a, b, c, spacing):
    """Barycentric lattice covering the face at <= `spacing` pitch."""
    e1, e2 = b - a, c - a
    n1 = max(int(np.ceil(np.linalg.norm(e1) / spacing)), 1)
    n2 = max(int(np.ceil(np.linalg.norm(e2) / spacing)), 1)
    pts = []
    for i in range(n1 + 1):
        u = i / n1
        # The extent along e2 shrinks with u (barycentric constraint).
        m = int(np.ceil((1.0 - u) * n2))
        if m == 0:
            pts.append(a + u * e1)
            continue
        v = np.arange(m + 1, dtype=np.float64) / n2
        v = v[v <= 1.0 - u + 1e-9]
        pts.append(a[None, :] + u * e1[None, :] + v[:, None] * e2[None, :])
    return np.concatenate([p.reshape(-1, len(a)) for p in pts], axis=0)


_native_lib = None


def _load_native():
    """The C++ sampler, compiled from native/sampler.cpp into _build/ on
    first use (the library name carries a hash of the source); None where
    there is no compiler or the build fails."""
    global _native_lib
    if _native_lib is not None:
        return _native_lib or None
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    try:
        if cxx is None:
            raise OSError("no C++ compiler")
        digest = hashlib.sha1(_NATIVE_SRC.read_bytes()).hexdigest()[:12]
        so = _BUILD / f"libwgsampler-{digest}.so"
        if not so.exists():
            _BUILD.mkdir(exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run([cxx, "-O3", "-fPIC", "-shared", "-std=c++17", "-o",
                            str(tmp), str(_NATIVE_SRC)], check=True,
                           capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.wgs_sample_trimesh.restype = ctypes.c_int64
        lib.wgs_sample_trimesh.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.c_double,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ]
        _native_lib = lib
        return lib
    except (OSError, subprocess.CalledProcessError):
        _native_lib = False
        return None


def _sample_trimesh_native(lib, vertices, triangles, spacing):
    v = np.ascontiguousarray(vertices, np.float32)
    t = np.ascontiguousarray(triangles, np.int32)
    vp = v.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    tp = t.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    count = lib.wgs_sample_trimesh(vp, len(v), tp, len(t), spacing, None, None)
    pts = np.empty((count, 3), np.float32)
    prim = np.empty((count, 3), np.int32)
    lib.wgs_sample_trimesh(
        vp, len(v), tp, len(t), spacing,
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        prim.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return pts, prim


def _unit_normal(a, b, c):
    n = np.cross(b - a, c - a)
    nl = np.linalg.norm(n)
    return n / nl if nl > 1e-12 else np.array([0.0, 1.0, 0.0])


def sample_trimesh(vertices, triangles, cell_width, collider_id=0,
                   vertex_offset=0, use_native: bool = True):
    """Sample faces + unique edges at cell_width / sqrt(2) spacing."""
    vertices = np.asarray(vertices, np.float64)
    triangles = np.asarray(triangles, np.int64)
    spacing = cell_width / np.sqrt(2.0)

    lib = _load_native() if use_native else None
    if lib is not None:
        pts, prim = _sample_trimesh_native(lib, vertices, triangles, spacing)
        va = vertices[prim[:, 0]]
        vb = vertices[prim[:, 1]]
        vc = vertices[prim[:, 2]]
        nrm = np.cross(vb - va, vc - va)
        nl = np.linalg.norm(nrm, axis=-1, keepdims=True)
        nrm = np.where(nl > 1e-12, nrm / np.maximum(nl, 1e-30), [0.0, 1.0, 0.0])
        return MeshSamples(
            points=pts,
            primitives=(prim + vertex_offset).astype(np.int32),
            collider_ids=np.full(len(pts), collider_id, np.int32),
            vertices=vertices.astype(np.float32),
            normals=nrm.astype(np.float32),
        )

    pts, prims, norms = [], [], []
    for tri in triangles:
        a, b, c = vertices[tri[0]], vertices[tri[1]], vertices[tri[2]]
        p = sample_triangle_face(a, b, c, spacing)
        pts.append(p)
        prims.append(np.tile(tri, (len(p), 1)))
        norms.append(np.tile(_unit_normal(a, b, c), (len(p), 1)))
    # Unique edges: crack-free coverage on sharp creases.
    edges = set()
    for tri in triangles:
        for e in ((tri[0], tri[1]), (tri[1], tri[2]), (tri[2], tri[0])):
            edges.add((min(e), max(e)) if e[0] != e[1] else None)
    edges.discard(None)
    tri_of_edge = {}
    for ti, tri in enumerate(triangles):
        for e in ((tri[0], tri[1]), (tri[1], tri[2]), (tri[2], tri[0])):
            tri_of_edge.setdefault((min(e), max(e)), ti)
    for e in sorted(edges):
        p = sample_segment(vertices[e[0]], vertices[e[1]], spacing)
        tri = triangles[tri_of_edge[e]]
        pts.append(p)
        prims.append(np.tile(tri, (len(p), 1)))
        norms.append(np.tile(_unit_normal(vertices[tri[0]], vertices[tri[1]],
                                          vertices[tri[2]]), (len(p), 1)))

    points = np.concatenate(pts, axis=0)
    return MeshSamples(
        points=points.astype(np.float32),
        primitives=(np.concatenate(prims, axis=0) + vertex_offset).astype(np.int32),
        collider_ids=np.full(len(points), collider_id, np.int32),
        vertices=vertices.astype(np.float32),
        normals=np.concatenate(norms, axis=0).astype(np.float32),
    )


def sample_polyline(vertices, segments, cell_width, collider_id=0,
                    vertex_offset=0):
    """2D: sample each segment at cell_width / sqrt(2)."""
    vertices = np.asarray(vertices, np.float64)
    segments = np.asarray(segments, np.int64)
    spacing = cell_width / np.sqrt(2.0)
    pts, prims, norms = [], [], []
    for seg in segments:
        a, b = vertices[seg[0]], vertices[seg[1]]
        p = sample_segment(a, b, spacing)
        pts.append(p)
        prims.append(np.tile(seg, (len(p), 1)))
        t = b - a
        tl = np.linalg.norm(t)
        t = t / tl if tl > 1e-12 else np.array([1.0, 0.0])
        norms.append(np.tile(np.array([-t[1], t[0]]), (len(p), 1)))
    points = np.concatenate(pts, axis=0)
    return MeshSamples(
        points=points.astype(np.float32),
        primitives=(np.concatenate(prims, axis=0) + vertex_offset).astype(np.int32),
        collider_ids=np.full(len(points), collider_id, np.int32),
        vertices=vertices.astype(np.float32),
        normals=np.concatenate(norms, axis=0).astype(np.float32),
    )


def heightfield_to_trimesh(heights, scale):
    """Regular-grid heightfield -> (vertices, triangles).  heights [nx, nz];
    scale (sx, sy, sz): x in [-sx/2, sx/2], z in [-sz/2, sz/2],
    y = heights * sy (rapier's HeightField::to_trimesh convention)."""
    heights = np.asarray(heights, np.float64)
    nx, nz = heights.shape
    xs = np.linspace(-scale[0] / 2, scale[0] / 2, nx)
    zs = np.linspace(-scale[2] / 2, scale[2] / 2, nz)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    V = np.stack([X.ravel(), heights.ravel() * scale[1], Z.ravel()], axis=-1)
    tris = []
    for i in range(nx - 1):
        for j in range(nz - 1):
            v00, v01 = i * nz + j, i * nz + j + 1
            v10, v11 = (i + 1) * nz + j, (i + 1) * nz + j + 1
            tris.append((v00, v10, v11))
            tris.append((v00, v11, v01))
    return V, np.asarray(tris, np.int64)


def combine(samples_list):
    """Concatenate the MeshSamples of several colliders (one vertex pool)."""
    if not samples_list:
        return None
    return MeshSamples(*(np.concatenate([getattr(s, f.name) for s in samples_list])
                         for f in dataclasses.fields(MeshSamples)))
