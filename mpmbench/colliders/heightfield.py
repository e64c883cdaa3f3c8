"""Collider kind `heightfield` (3D), the yardstick's part: a regular
heightfield triangulated as rapier's HeightField::to_trimesh.

  make(spec, rng)                     the inputs: heights [nx, nz] =
                                      amplitude sin(x) cos(z) over `waves`
                                      radians on each axis plus noise
                                      N(0, noise) drawn from rng; scale;
  node_cdf(c, pose, grid, dtype, dev) the reference's node CDF of the
                                      collider at a pose (reference/mesh.py:
                                      the triangles' and edges' samples at
                                      cell_width / sqrt(2), taken once in
                                      the body's frame and placed by the
                                      pose).
"""

import numpy as np

from mpmbench.reference import mesh


def make(spec: dict, rng) -> dict:
    nx, nz = spec["resolution"]
    a = np.sin(np.linspace(0, spec["waves"], nx))[:, None]
    b = np.cos(np.linspace(0, spec["waves"], nz))[None, :]
    noise = rng.standard_normal((nx, nz))
    return {"heights": spec["amplitude"] * a * b + spec["noise"] * noise,
            "scale": tuple(spec["scale"])}


def node_cdf(c, pose, grid, dtype, device):
    if grid.h not in c.cache:
        v, tri = mesh.heightfield_trimesh(c.data["heights"], c.data["scale"])
        v = v.astype(np.float32).astype(np.float64)
        c.cache[grid.h] = (v, *mesh.sample_trimesh(v, tri, grid.h))
    return mesh.surface_cdf(*c.cache[grid.h], pose, grid, dtype, device)
