"""Particle state and per-particle models (port of wgsparkl_tpu/solver.py:
the host-side builder API ParticlePhase, ParticleDynamics and Particle;
Particles and Models with their bulk (`from_arrays`) and per-particle
(`from_particles`) builders; attach_material_table).

State is a dataclass of [N, ...] tensors on one device; the affinity word
rides as int32 holding the uint32 bit pattern (16 affinity bits | 16 sign
bits).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from wgsparkl_tpu_torch.device import resolve
from wgsparkl_tpu_torch.models import DruckerPrager, ElasticCoefficients


def _f32(x, device, shape=None):
    t = torch.as_tensor(np.asarray(x, np.float32), device=device)
    return t.expand(shape).clone() if shape is not None else t.clone()


@dataclasses.dataclass(frozen=True)
class ParticlePhase:
    """phase 1: intact elastic; phase 0: granular or failed.  max_stretch
    <= 0 disables the fracture check."""

    phase: float = 0.0
    max_stretch: float = -1.0


@dataclasses.dataclass(frozen=True)
class ParticleDynamics:
    velocity: tuple
    init_volume: float
    init_radius: float
    mass: float

    @staticmethod
    def with_density(radius: float, density: float, dim: int = 3) -> "ParticleDynamics":
        """A square particle of side 2 radius at rest."""
        init_volume = (2.0 * radius) ** dim
        return ParticleDynamics(velocity=(0.0,) * dim, init_volume=init_volume,
                                init_radius=radius, mass=init_volume * density)


@dataclasses.dataclass(frozen=True)
class Particle:
    """One particle of a scene built on the host (Particles.from_particles,
    Models.from_particles)."""

    position: tuple
    dynamics: ParticleDynamics
    model: ElasticCoefficients
    plasticity: Optional[DruckerPrager] = None
    phase: Optional[ParticlePhase] = None


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
    def from_arrays(positions, velocities=None, *, mass=None, density=None,
                    radius=None, init_volume=None, device=None) -> "Particles":
        """Particles at positions [N, d] (velocities broadcast to [N, d], zero
        by default) from (density, radius): square particles of side
        2 radius, volume side^d; or from explicit (mass, init_volume,
        radius), each broadcast to [N]."""
        device = resolve(device)
        pos = _f32(positions, device)
        n, d = pos.shape
        if d not in (2, 3):
            raise ValueError(f"positions must be [N, 2] or [N, 3], got {pos.shape}")
        vel = (torch.zeros_like(pos) if velocities is None
               else _f32(velocities, device, (n, d)))
        if init_volume is None:
            if density is None or radius is None:
                raise ValueError("need (density, radius) or explicit volumes")
            radius = _f32(radius, device, (n,))
            side = 2.0 * radius
            init_volume = side * side * side if d == 3 else side * side
            mass = init_volume * _f32(density, device, (n,))
        else:
            init_volume = _f32(init_volume, device, (n,))
            radius = _f32(radius, device, (n,))
            mass = _f32(mass, device, (n,))
        z3 = torch.zeros((n, d), dtype=torch.float32, device=device)
        return Particles(
            pos=pos, vel=vel,
            def_grad=torch.eye(d, device=device).expand(n, d, d).clone(),
            affine=torch.zeros((n, d, d), device=device),
            init_volume=init_volume, init_radius=radius, mass=mass,
            cdf_normal=z3.clone(), cdf_rigid_vel=z3.clone(),
            cdf_signed_distance=torch.zeros(n, device=device),
            cdf_affinity=torch.zeros(n, dtype=torch.int32, device=device),
            ids=torch.arange(n, dtype=torch.int32, device=device),
        )

    @staticmethod
    def from_particles(particles: Sequence[Particle], device=None) -> "Particles":
        """The bulk state of a list of Particle objects."""
        col = lambda f: np.asarray([f(p) for p in particles], np.float32)  # noqa: E731
        return Particles.from_arrays(
            col(lambda p: p.position), col(lambda p: p.dynamics.velocity),
            mass=col(lambda p: p.dynamics.mass),
            init_volume=col(lambda p: p.dynamics.init_volume),
            radius=col(lambda p: p.dynamics.init_radius), device=device)


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

    @staticmethod
    def from_particles(particles: Sequence[Particle], device=None) -> "Models":
        """The per-particle models of a list of Particle objects (no
        plasticity: DruckerPrager.disabled(); no phase: phase 0, no fracture
        check)."""
        from wgsparkl_tpu_torch.models.drucker_prager import drucker_prager_arrays

        col = lambda f: np.asarray([f(p) for p in particles], np.float32)  # noqa: E731
        dps = [p.plasticity if p.plasticity is not None else DruckerPrager.disabled()
               for p in particles]
        return Models.from_arrays(
            len(particles), col(lambda p: p.model.lam), col(lambda p: p.model.mu),
            dp=drucker_prager_arrays(dps),
            phase=col(lambda p: p.phase.phase if p.phase is not None else 0.0),
            max_stretch=col(lambda p: p.phase.max_stretch if p.phase is not None
                            else -1.0),
            device=device)


def attach_material_table(particles: Particles, models: Models,
                          limit: Optional[int] = 128):
    """Dedupe the immutable per-particle constants into a material table
    (rows lam, mu, dp h0..h3/lam/mu, max_stretch, init_volume, init_radius;
    lanes = material ids).  Returns (models with mat_id/mat_table, count).
    The pallas path holds at most `limit` = 128 materials in a [16, 128]
    table and raises past it, as the JAX package does; the dense and
    blocked transfers pass limit=None and get [16, M] lanes, M = 128
    ceil(count / 128), sized from the count, never from N."""
    cols = ([models.lam, models.mu] + [models.dp[k] for k in DP_KEYS]
            + [models.max_stretch, particles.init_volume, particles.init_radius])
    key = np.stack([c.cpu().numpy() for c in cols], axis=1)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    if limit is not None and len(uniq) > limit:
        raise ValueError(
            f"pallas path supports <= {limit} distinct materials, got "
            f"{len(uniq)} (use transfer='blocked'/'dense' for per-particle "
            "continuous material variation)")
    table = np.zeros((16, 128 * -(-len(uniq) // 128)), np.float32)
    table[:11, : len(uniq)] = uniq.T
    dev = models.lam.device
    return dataclasses.replace(
        models,
        mat_id=torch.as_tensor(inv.reshape(-1).astype(np.float32), device=dev),
        mat_table=torch.as_tensor(table, device=dev),
    ), len(uniq)
