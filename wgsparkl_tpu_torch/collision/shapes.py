"""Collider descriptions (port of the Collider part of
wgsparkl_tpu/collision/shapes.py: the analytic cuboid, ball, capsule and
halfspace, with the JAX package's shape-type ids and parameter layout, and
the mesh shapes polyline, trimesh and heightfield, which carry vertices and
indices), the analytic shapes' boundary projection,
`project_on_boundary`, and the mesh utilities `closest_point_on_triangles`
and `closest_point_on_segments`.  Mesh shapes reach the node CDF through
their surface samples (rigid/sampling.py, ops/rigid_cdf.py)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

# The JAX package's shape-type ids.
SHAPE_CUBOID = 0
SHAPE_BALL = 1
SHAPE_CAPSULE = 2
SHAPE_HALFSPACE = 3
SHAPE_POLYLINE = 4
SHAPE_TRIMESH = 5
SHAPE_HEIGHTFIELD = 6
ANALYTIC = (SHAPE_CUBOID, SHAPE_BALL, SHAPE_CAPSULE, SHAPE_HALFSPACE)
MESH = (SHAPE_POLYLINE, SHAPE_TRIMESH, SHAPE_HEIGHTFIELD)


@dataclasses.dataclass(frozen=True)
class Collider:
    """shape_type: one of ANALYTIC or MESH.  params, padded to length 8:
      cuboid:    half-extents[0:d]
      ball:      [radius]
      capsule:   [half_height, radius]  (axis = local +y)
      halfspace: [] (boundary = local y = 0 plane, inside = y < 0)
      polyline, trimesh, heightfield: [] (zeros); `vertices` [V, d] f32 in
        the body's frame and `indices` [T, d] int32 (segments, triangles)
        instead.  Equality and the hash see shape_type and params only.
    """

    shape_type: int
    params: Tuple[float, ...] = ()
    vertices: Optional[np.ndarray] = dataclasses.field(default=None, compare=False)
    indices: Optional[np.ndarray] = dataclasses.field(default=None, compare=False)

    def padded_params(self) -> np.ndarray:
        p = np.zeros(8, np.float32)
        p[: len(self.params)] = self.params
        return p

    @staticmethod
    def cuboid(*half_extents: float) -> "Collider":
        return Collider(SHAPE_CUBOID, tuple(float(h) for h in half_extents))

    @staticmethod
    def ball(radius: float) -> "Collider":
        return Collider(SHAPE_BALL, (float(radius),))

    @staticmethod
    def capsule(half_height: float, radius: float) -> "Collider":
        return Collider(SHAPE_CAPSULE, (float(half_height), float(radius)))

    @staticmethod
    def halfspace() -> "Collider":
        return Collider(SHAPE_HALFSPACE, ())

    @staticmethod
    def trimesh(vertices, indices) -> "Collider":
        return Collider(SHAPE_TRIMESH, (), vertices=np.asarray(vertices, np.float32),
                        indices=np.asarray(indices, np.int32))

    @staticmethod
    def heightfield(heights, scale) -> "Collider":
        """A regular-grid heightfield [nx, nz] over x in [-sx/2, sx/2], z in
        [-sz/2, sz/2] at y = heights * sy, turned into a trimesh now."""
        from wgsparkl_tpu_torch.rigid.sampling import heightfield_to_trimesh

        v, t = heightfield_to_trimesh(heights, scale)
        return Collider(SHAPE_HEIGHTFIELD, (), vertices=np.asarray(v, np.float32),
                        indices=np.asarray(t, np.int32))

    @staticmethod
    def polyline(vertices, indices=None) -> "Collider":
        """2D segments; indices None chains consecutive vertices."""
        v = np.asarray(vertices, np.float32)
        if indices is None:
            k = len(v) - 1
            indices = np.stack([np.arange(k), np.arange(1, k + 1)], axis=-1)
        return Collider(SHAPE_POLYLINE, (), vertices=v,
                        indices=np.asarray(indices, np.int32))

    @property
    def is_analytic(self) -> bool:
        return self.shape_type in ANALYTIC


def project_on_boundary_ch(shape_type: int, params, rot, trans, pts):
    """Channel form of project_on_boundary: pts d channels [M], rot and
    trans sequences of 0-d tensors; (dpt channels, inside [M])."""
    from wgsparkl_tpu_torch.collision import cdf_channel as cch

    q = cch._to_local(rot, trans, pts)
    proj, inside = cch.project(shape_type, params, q)
    w = cch._to_world_vec(rot, proj)
    return [(w[a] + trans[a]) - pts[a] for a in range(len(pts))], inside


def project_on_boundary(shape_type: int, params, rot, trans, points):
    """World points [M, d] projected on the boundary of one posed analytic
    collider (params [8], rot [4] or [2], trans [d]): (dpt [M, d], the
    closest boundary point minus the point; inside [M] bool)."""
    dpt, inside = project_on_boundary_ch(shape_type, params, rot.unbind(0),
                                         trans.unbind(0), points.unbind(-1))
    return torch.stack(dpt, -1), inside


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _safe(x):
    """x where |x| > 1e-30, else 1e-30 (a divisor)."""
    return torch.where(torch.abs(x) > 1e-30, x, 1e-30)


def closest_point_on_triangles(p, a, b, c):
    """The closest point of each triangle (a, b, c) to each point p, all
    [..., 3] (Ericson, Real-Time Collision Detection 5.1.5: the vertex,
    edge or face region, branch-free)."""
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    bp = p - b
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    cp = p - c
    d5, d6 = _dot(ab, cp), _dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = _safe(va + vb + vc)
    pt = a + ab * (vb / denom)[..., None] + ac * (vc / denom)[..., None]
    t_ab = torch.clamp(d1 / _safe(d1 - d3), 0.0, 1.0)
    t_ac = torch.clamp(d2 / _safe(d2 - d6), 0.0, 1.0)
    t_bc = torch.clamp((d4 - d3) / _safe((d4 - d3) + (d5 - d6)), 0.0, 1.0)
    for region, q in (
            ((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0), b + (c - b) * t_bc[..., None]),
            ((vb <= 0) & (d2 >= 0) & (d6 <= 0), a + ac * t_ac[..., None]),
            ((vc <= 0) & (d1 >= 0) & (d3 <= 0), a + ab * t_ab[..., None]),
            ((d6 >= 0) & (d5 <= d6), c),
            ((d3 >= 0) & (d4 <= d3), b),
            ((d1 <= 0) & (d2 <= 0), a)):
        pt = torch.where(region[..., None], q, pt)
    return pt


def closest_point_on_segments(p, a, b):
    """The closest point of each segment (a, b) to each point p, all
    [..., d]."""
    ab = b - a
    t = torch.clamp(_dot(p - a, ab) / torch.clamp(_dot(ab, ab), min=1e-30), 0.0, 1.0)
    return a + ab * t[..., None]
