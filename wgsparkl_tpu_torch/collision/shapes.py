"""Analytic collider descriptions (port of the Collider part of
wgsparkl_tpu/collision/shapes.py: cuboid, ball, capsule and halfspace, with
the JAX package's shape-type ids and parameter layout).  Mesh shapes
(polyline, trimesh, heightfield) are not ported (ROADMAP queue 1, item 8)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

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
