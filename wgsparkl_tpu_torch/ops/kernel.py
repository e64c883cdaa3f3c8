"""Quadratic B-spline kernel helpers (port of wgsparkl_tpu/ops/kernel.py)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from wgsparkl_tpu_torch.math import div


def inv_d(cell_width):
    """APIC D^-1 scale for the quadratic kernel: 4 / h^2."""
    return 4.0 / (cell_width * cell_width)


def axis_weights(xf):
    """The three per-axis B-spline weights at offsets 0, 1, 2 for the
    fractional offset xf = p/h - base in [0.5, 1.5]."""
    a = 1.5 - xf
    b = xf - 1.0
    c = xf - 0.5
    return 0.5 * (a * a), 0.75 - b * b, 0.5 * (c * c)


def eval_all(x):
    """[..., 3] per-axis B-spline weights at offsets 0, 1, 2 of x = p/h -
    base in [0.5, 1.5]."""
    return torch.stack(axis_weights(x), dim=-1)


@functools.lru_cache(maxsize=None)
def stencil_offsets(dim: int) -> np.ndarray:
    """Static [3^dim, dim] int32 stencil offsets in {0,1,2}^dim, the last
    axis fastest."""
    grids = np.meshgrid(*([np.arange(3)] * dim), indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1).astype(np.int32)


def stencil_base_and_weights(pos, cell_width: float):
    """Stencil of particles at pos [N, d]: base cell round(p / h) - 1 [N, d]
    int32 (IEEE division, halves to even), weights [N, 3^d] (the per-axis
    weights multiplied axis by axis) and node deltas node - p [N, 3^d, d]."""
    d = pos.shape[-1]
    u = div(pos, cell_width)
    base = torch.round(u).to(torch.int32) - 1
    wa = [axis_weights(u[:, a] - base[:, a].to(pos.dtype)) for a in range(d)]
    offs = stencil_offsets(d)
    w = torch.stack([functools.reduce(lambda acc, a: acc * wa[a][int(o[a])],
                                      range(1, d), wa[0][int(o[0])]) for o in offs], 1)
    cells = base[:, None, :] + torch.as_tensor(offs, device=pos.device)[None]
    dpt = cells.to(pos.dtype) * cell_width - pos[:, None, :]
    return base, w, dpt
