"""Collider descriptions (port of the Collider part of
wgsparkl_tpu/collision/shapes.py: the analytic cuboid, ball, capsule and
halfspace, with the JAX package's shape-type ids and parameter layout, and
the mesh shapes polyline, trimesh and heightfield, which carry vertices and
indices) and the analytic shapes' boundary projection,
`project_on_boundary`.  Mesh shapes reach the node CDF through their surface
samples (rigid/sampling.py, ops/rigid_cdf.py)."""

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
