"""Analytic collider descriptions (port of the Collider part of
wgsparkl_tpu/collision/shapes.py: cuboid, ball, capsule and halfspace, with
the JAX package's shape-type ids and parameter layout) and their boundary
projection, `project_on_boundary`.  Mesh shapes (polyline, trimesh,
heightfield) are not ported (ROADMAP queue 1, item 8)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# The JAX package's shape-type ids.
SHAPE_CUBOID = 0
SHAPE_BALL = 1
SHAPE_CAPSULE = 2
SHAPE_HALFSPACE = 3
ANALYTIC = (SHAPE_CUBOID, SHAPE_BALL, SHAPE_CAPSULE, SHAPE_HALFSPACE)


@dataclasses.dataclass(frozen=True)
class Collider:
    """shape_type: one of ANALYTIC.  params, padded to length 8:
      cuboid:    half-extents[0:d]
      ball:      [radius]
      capsule:   [half_height, radius]  (axis = local +y)
      halfspace: [] (boundary = local y = 0 plane, inside = y < 0)
    """

    shape_type: int
    params: Tuple[float, ...] = ()

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
