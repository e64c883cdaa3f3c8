"""Collider kind `polyline` (2D), the yardstick's part: a fixed polyline
given by its vertices, joined in order.

  make(spec, rng)               the inputs: vertices [V, 2] float32;
  node_cdf(c, grid, dtype, dev) the reference's node CDF of the collider
                                (reference/mesh.py: samples at
                                cell_width / sqrt(2) along every segment).
"""

import numpy as np

from mpmbench.reference import mesh


def make(spec: dict, rng) -> dict:
    return {"vertices": np.asarray(spec["vertices"], np.float32)}


def node_cdf(c, grid, dtype, device):
    v = c.data["vertices"].astype(np.float64)
    k = np.arange(len(v) - 1)
    points, prims = mesh.sample_polylines(v, np.stack([k, k + 1], -1), grid.h)
    return mesh.surface_cdf(v, points, prims, c.translation, grid, dtype, device)
