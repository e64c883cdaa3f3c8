"""Simulation parameters (port of wgsparkl_tpu/params.py)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wgsparkl_tpu_torch.device import resolve


@dataclasses.dataclass
class SimulationParams:
    dt: float         # substep length (host float; f32-rounded like JAX's)
    gravity: torch.Tensor  # [d] f32

    @staticmethod
    def new(dt: float, gravity, device=None) -> "SimulationParams":
        return SimulationParams(
            dt=float(torch.tensor(dt, dtype=torch.float32)),
            gravity=torch.as_tensor(gravity, dtype=torch.float32,
                                    device=resolve(device)).clone(),
        )


def velocity_limit(cell_width: float, dt: float) -> float:
    """The one-cell-per-substep speed limit cell_width / dt, divided in f32
    as the JAX package divides it (f32(cell_width) / f32(dt))."""
    return float(np.float32(cell_width) / np.float32(dt))
