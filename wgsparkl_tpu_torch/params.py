"""Simulation parameters (port of wgsparkl_tpu/params.py)."""

from __future__ import annotations

import dataclasses

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
