"""Collider kind `polyline` (2D), the yardstick's part: a polyline given by
its vertices, joined in order.

  make(spec, rng)                     the inputs: vertices [V, 2] float32;
  node_cdf(c, pose, grid, dtype, dev) the reference's node CDF of the
                                      collider at a pose (reference/mesh.py:
                                      samples at cell_width / sqrt(2) along
                                      every segment, taken once in the
                                      body's frame and placed by the pose).
"""

import numpy as np

from mpmbench.reference import mesh


def make(spec: dict, rng) -> dict:
    return {"vertices": np.asarray(spec["vertices"], np.float32)}


def node_cdf(c, pose, grid, dtype, device):
    if grid.h not in c.cache:
        v = c.data["vertices"].astype(np.float64)
        k = np.arange(len(v) - 1)
        c.cache[grid.h] = (v, *mesh.sample_polylines(v, np.stack([k, k + 1], -1), grid.h))
    return mesh.surface_cdf(*c.cache[grid.h], pose, grid, dtype, device)
