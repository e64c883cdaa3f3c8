"""Collider kind `cuboid` (2D and 3D), the yardstick's part: a box given by
its half extents, centred on its body's origin.

  make(spec, rng)                     the inputs: half_extents [d];
  node_cdf(c, pose, grid, dtype, dev) the reference's node CDF of the box at
                                      a pose, at every grid node.

The node CDF is upstream wgsparkl's analytic one (collide.wgsl, as
tests/oracle_cpic.py transcribes it): a node q in the box's frame lies
inside where |q_a| < h_a on every axis, and then projects onto the face of
its smallest gap h_a - |q_a| (the first such axis on a tie; the face on
q_a's side, + where q_a = 0); outside, it projects onto the clamped point.
The box reaches a node that it holds, or whose world offset to the
projection is at most 1.5 cells on every axis; there it sets its affinity
bit, its sign bit where it holds the node, and the distance |offset|.
"""

import numpy as np
import torch


def make(spec: dict, rng) -> dict:
    return {"half_extents": np.asarray(spec["half_extents"], np.float64)}


def node_cdf(c, pose, grid, dtype, device):
    d = grid.dim
    t, r = (torch.as_tensor(np.asarray(x, np.float64), device=device).to(dtype)
            for x in pose)
    he = torch.as_tensor(c.data["half_extents"], device=device).to(dtype)
    axes = [torch.arange(n, device=device) + o for o, n in zip(grid.origin, grid.shape)]
    cells = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, d)
    q = (cells.to(dtype) * grid.h - t) @ r            # R^T (x - t), row by row
    inside = (q.abs() < he).all(1)
    face = torch.nn.functional.one_hot((he - q.abs()).argmin(1), d).bool()
    snapped = torch.where(q >= 0, he, -he)
    proj = torch.where(inside[:, None] & face, snapped, torch.minimum(torch.maximum(q, -he), he))
    off = (proj - q) @ r.T
    within = inside | (off.abs() <= 1.5 * grid.h).all(1)
    dist = torch.where(within, torch.sqrt((off * off).sum(1)),
                       torch.full_like(off[:, 0], float("inf")))
    return dist, within, inside
