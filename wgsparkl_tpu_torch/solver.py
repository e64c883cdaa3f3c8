"""Particle state and per-particle models (port of wgsparkl_tpu/solver.py:
Particles, Models, attach_material_table).

State is a dataclass of [N, ...] tensors on one device; the affinity word
rides as int32 holding the uint32 bit pattern (16 affinity bits | 16 sign
bits).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from wgsparkl_tpu_torch.device import resolve


def _f32(x, device, shape=None):
    t = torch.as_tensor(np.asarray(x, np.float32), device=device)
    return t.expand(shape).clone() if shape is not None else t.clone()


@dataclasses.dataclass
class Particles:
    pos: torch.Tensor          # [N, d], d = 2 or 3
    vel: torch.Tensor          # [N, d]
    def_grad: torch.Tensor     # [N, d, d]
    affine: torch.Tensor       # [N, d, d]
    init_volume: torch.Tensor  # [N]
    init_radius: torch.Tensor  # [N]
    mass: torch.Tensor         # [N]
    cdf_normal: torch.Tensor   # [N, d]
    cdf_rigid_vel: torch.Tensor  # [N, d]
    cdf_signed_distance: torch.Tensor  # [N]
    cdf_affinity: torch.Tensor  # [N] int32 (uint32 bit pattern)
    ids: torch.Tensor          # [N] int32 scene-construction index

    @property
    def dim(self) -> int:
        return self.pos.shape[-1]

    @property
    def count(self) -> int:
        return self.pos.shape[0]

    @staticmethod
    def from_arrays(positions, *, density, radius, device=None) -> "Particles":
        """Particles at positions [N, d] from a density and a radius (the
        (density, radius) form of the JAX package's constructor): square particles
        of side 2 radius, volume side^d."""
        device = resolve(device)
        pos = _f32(positions, device)
        n, d = pos.shape
        if d not in (2, 3):
            raise ValueError(f"positions must be [N, 2] or [N, 3], got {pos.shape}")
        radius = _f32(radius, device, (n,))
        side = 2.0 * radius
        init_volume = side * side * side if d == 3 else side * side
        mass = init_volume * _f32(density, device, (n,))
        z3 = torch.zeros((n, d), dtype=torch.float32, device=device)
        return Particles(
            pos=pos, vel=z3.clone(),
            def_grad=torch.eye(d, device=device).expand(n, d, d).clone(),
            affine=torch.zeros((n, d, d), device=device),
            init_volume=init_volume, init_radius=radius, mass=mass,
            cdf_normal=z3.clone(), cdf_rigid_vel=z3.clone(),
            cdf_signed_distance=torch.zeros(n, device=device),
            cdf_affinity=torch.zeros(n, dtype=torch.int32, device=device),
            ids=torch.arange(n, dtype=torch.int32, device=device),
        )


DP_KEYS = ("h0", "h1", "h2", "h3", "lam", "mu")
DPS_KEYS = ("det", "hardening", "log_vol_gain")


@dataclasses.dataclass
class Models:
    lam: torch.Tensor
    mu: torch.Tensor
    dp: dict
    dp_state: dict
    phase: torch.Tensor
    max_stretch: torch.Tensor
    mat_id: Optional[torch.Tensor] = None     # [N] f32 integer-valued
    mat_table: Optional[torch.Tensor] = None  # [16, 128] f32

    @staticmethod
    def from_arrays(n, lam, mu, dp=None, phase=None, max_stretch=None,
                    device=None) -> "Models":
        device = resolve(device)
        if dp is None:
            dp = {k: -1.0 for k in DP_KEYS}
        return Models(
            lam=_f32(lam, device, (n,)), mu=_f32(mu, device, (n,)),
            dp={k: _f32(v, device, (n,)) for k, v in dp.items()},
            dp_state={
                "det": torch.ones(n, device=device),
                "hardening": torch.ones(n, device=device),
                "log_vol_gain": torch.zeros(n, device=device),
            },
            phase=_f32(0.0 if phase is None else phase, device, (n,)),
            max_stretch=_f32(-1.0 if max_stretch is None else max_stretch,
                             device, (n,)),
        )


def attach_material_table(particles: Particles, models: Models):
    """Dedupe the immutable per-particle constants into a [16, 128] table
    (rows lam, mu, dp h0..h3/lam/mu, max_stretch, init_volume, init_radius;
    lanes = material ids).  Returns (models with mat_id/mat_table, count)."""
    cols = ([models.lam, models.mu] + [models.dp[k] for k in DP_KEYS]
            + [models.max_stretch, particles.init_volume, particles.init_radius])
    key = np.stack([c.cpu().numpy() for c in cols], axis=1)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    if len(uniq) > 128:
        raise ValueError(f"at most 128 distinct materials, got {len(uniq)}")
    table = np.zeros((16, 128), np.float32)
    table[:11, : len(uniq)] = uniq.T
    dev = models.lam.device
    return dataclasses.replace(
        models,
        mat_id=torch.as_tensor(inv.reshape(-1).astype(np.float32), device=dev),
        mat_table=torch.as_tensor(table, device=dev),
    ), len(uniq)
