"""Dense bounded MPM grid geometry (port of wgsparkl_tpu/grid.py).

The dense transfer addresses nodes row-major (the last axis fastest) by
flat index; that grid need not be whole blocks."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from wgsparkl_tpu_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Nodes sit at world positions (origin_cell + i) * cell_width per axis."""

    shape: Tuple[int, ...]
    cell_width: float
    origin_cell: Tuple[int, ...]

    @property
    def dim(self) -> int:
        return len(self.shape)

    @property
    def num_nodes(self) -> int:
        return int(np.prod(self.shape))

    def node_positions(self, device=None):
        """[num_nodes, d] world positions of all nodes, row-major, on `device`
        (None: the card)."""
        return torch.stack(self.node_position_channels(resolve(device)), dim=-1)

    def node_position_channels(self, device=None):
        """d channels [num_nodes] of the nodes' world coordinates, row-major."""
        idx = torch.arange(self.num_nodes, dtype=torch.int32, device=device)
        out, stride = [], self.num_nodes
        for a in range(self.dim):
            stride //= self.shape[a]
            coord = (idx // stride) % self.shape[a] + int(self.origin_cell[a])
            out.append(coord.to(torch.float32) * self.cell_width)
        return out

    def flatten_index(self, cell):
        """World integer cells [..., d] -> row-major flat node index [...]
        (no clip)."""
        flat = cell[..., 0] - int(self.origin_cell[0])
        for a in range(1, self.dim):
            flat = flat * self.shape[a] + (cell[..., a] - int(self.origin_cell[a]))
        return flat

    def in_bounds(self, cell):
        """World integer cells [..., d] -> bool [...]: the node is on the grid."""
        ok = None
        for a in range(self.dim):
            i = cell[..., a] - int(self.origin_cell[a])
            oka = (i >= 0) & (i < self.shape[a])
            ok = oka if ok is None else ok & oka
        return ok

    @staticmethod
    def from_bounds(lo, hi, cell_width: float, margin_cells: int = 3) -> "GridConfig":
        """Grid covering [lo, hi] plus a margin, rounded up to whole 4^3
        (3D) / 8^2 (2D) blocks."""
        lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
        bs = 4 if len(lo) == 3 else 8
        origin = np.floor(lo / cell_width).astype(np.int64) - margin_cells
        top = np.ceil(hi / cell_width).astype(np.int64) + margin_cells
        shape = tuple(int(-((t - o + 1) // -bs) * bs) for o, t in zip(origin, top))
        return GridConfig(shape=shape, cell_width=float(cell_width),
                          origin_cell=tuple(int(o) for o in origin))
