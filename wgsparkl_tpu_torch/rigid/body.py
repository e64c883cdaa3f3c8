"""Rigid-body state and the coupling ops (port of wgsparkl_tpu/rigid/body.py:
BodyCoupling, RigidWorld, make_rigid_world, velocity_at_point,
update_world_mass_properties, apply_impulse, integrate_velocity,
shape_mass_properties).  Slots <= 16
(the CPIC affinity word).  Fixed and kinematic bodies have zero inverse
mass; dynamic bodies get theirs from shape_mass_properties and are moved by
the CPIC impulses, gravity, body contacts (rigid/contacts.py) and joints
(rigid/joints.py).

3D: rot a quaternion [B, 4], angvel [B, 3], inertia [B, 3, 3].
2D: rot a unit complex [B, 2] (cos, sin), angvel [B, 1], inertia [B, 1, 1].
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wgsparkl_tpu_torch.device import resolve
from wgsparkl_tpu_torch.math import pose as pose_math


@dataclasses.dataclass
class BodyCoupling:
    """Per-slot coupling flags: two_way [B] bool, the dynamic bodies that
    take the CPIC impulses (the steps take the same choice as
    MpmConfig.coupling)."""

    two_way: torch.Tensor


@dataclasses.dataclass
class RigidWorld:
    rot: torch.Tensor               # [B, 4] or [B, 2]
    pos: torch.Tensor               # [B, d]
    linvel: torch.Tensor            # [B, d]
    angvel: torch.Tensor            # [B, 3] or [B, 1]
    local_com: torch.Tensor         # [B, d]
    world_com: torch.Tensor         # [B, d]
    inv_mass: torch.Tensor          # [B, d]
    inv_inertia_local: torch.Tensor  # [B, 3, 3] or [B, 1, 1]
    inv_inertia_world: torch.Tensor
    shape_params: torch.Tensor      # [B, 8]

    @property
    def count(self) -> int:
        return self.pos.shape[0]

    @property
    def dim(self) -> int:
        return self.pos.shape[-1]


def make_rigid_world(dim: int, count: int, device=None) -> RigidWorld:
    """An empty world of `count` static slots at the origin on `device`
    (None: the card)."""
    device = resolve(device)
    ang = 3 if dim == 3 else 1
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)  # noqa: E731
    return RigidWorld(
        rot=pose_math.rot_identity(dim, (count,), device=device), pos=z(count, dim),
        linvel=z(count, dim), angvel=z(count, ang), local_com=z(count, dim),
        world_com=z(count, dim), inv_mass=z(count, dim),
        inv_inertia_local=z(count, ang, ang), inv_inertia_world=z(count, ang, ang),
        shape_params=z(count, 8))


def velocity_at_point(bodies: RigidWorld, idx, point):
    """Velocity of the bodies idx [...] (int slots) at world points
    [..., d]: lin + ang x (point - world COM); in 2D the angular velocity
    turns the lever by 90 degrees.  (ops/transfer.velocity_at_point is the
    same on the body table.)"""
    idx = idx.long()
    lin = bodies.linvel[idx]
    ang = bodies.angvel[idx]
    rel = point - bodies.world_com[idx]
    if bodies.dim == 3:
        return lin + pose_math._cross(ang, rel)
    perp = torch.stack([-rel[..., 1], rel[..., 0]], dim=-1)
    return lin + ang[..., 0:1] * perp


def update_world_mass_properties(bodies: RigidWorld) -> RigidWorld:
    world_com = pose_math.transform_point(bodies.rot, bodies.pos, bodies.local_com)
    if bodies.dim == 3:
        r = pose_math.quat_to_matrix(bodies.rot)
        inv_i = torch.einsum("bik,bkl,bjl->bij", r, bodies.inv_inertia_local, r)
    else:
        inv_i = bodies.inv_inertia_local
    return dataclasses.replace(bodies, world_com=world_com, inv_inertia_world=inv_i)


def apply_impulse(bodies: RigidWorld, lin_impulse, ang_impulse):
    new_lin = bodies.linvel + lin_impulse * bodies.inv_mass
    new_ang = bodies.angvel + torch.einsum(
        "bij,bj->bi", bodies.inv_inertia_world, ang_impulse)
    return new_lin, new_ang


def integrate_velocity(bodies: RigidWorld, linvel, angvel, dt):
    """Rotate about the world COM and translate; a body with exactly zero
    velocity keeps its pose bit for bit (the frame-hoisted static CDF relies
    on it)."""
    new_com = bodies.world_com + linvel * dt
    if bodies.dim == 3:
        dq = pose_math.quat_from_scaled_axis(angvel * dt)
        new_rot = pose_math.quat_normalize(pose_math.quat_mul(dq, bodies.rot))
    else:
        dr = pose_math.rot2_from_angle(angvel[..., 0] * dt)
        new_rot = pose_math.rot2_normalize(pose_math.rot2_mul(dr, bodies.rot))
    new_pos = new_com - pose_math.rotate(new_rot, bodies.local_com)
    still = (torch.all(angvel == 0.0, dim=-1, keepdim=True)
             & torch.all(linvel == 0.0, dim=-1, keepdim=True))
    return (torch.where(still, bodies.rot, new_rot),
            torch.where(still, bodies.pos, new_pos))


def shape_mass_properties(collider, density: float, dim: int):
    """(mass, local_com, inertia) of a primitive shape (host numpy; a copy
    of the JAX package's): a capsule is a cylinder plus a ball; a halfspace
    has infinite mass and no inertia."""
    st = collider.shape_type
    p = collider.params
    if st == 0:  # cuboid
        he = np.asarray(p[:dim], np.float64)
        mass = density * float(np.prod(2.0 * he))
        if dim == 3:
            ex, ey, ez = 2.0 * he
            inertia = np.diag(mass / 12.0 * np.array(
                [ey**2 + ez**2, ex**2 + ez**2, ex**2 + ey**2]))
        else:
            ex, ey = 2.0 * he
            inertia = np.array([[mass * (ex**2 + ey**2) / 12.0]])
        return mass, np.zeros(dim), inertia
    if st == 1:  # ball
        r = p[0]
        if dim == 3:
            mass = density * (4.0 / 3.0 * np.pi * r**3)
            i = 0.4 * mass * r * r
            inertia = np.diag([i, i, i])
        else:
            mass = density * (np.pi * r**2)
            inertia = np.array([[0.5 * mass * r * r]])
        return mass, np.zeros(dim), inertia
    if st == 2:  # capsule
        hh, r = p[0], p[1]
        if dim == 3:
            vol_cyl = np.pi * r * r * 2 * hh
            vol_sph = 4.0 / 3.0 * np.pi * r**3
            mass = density * (vol_cyl + vol_sph)
            m_cyl, m_sph = density * vol_cyl, density * vol_sph
            ixx = m_cyl * (3 * r * r + (2 * hh) ** 2) / 12.0 + m_sph * (
                0.4 * r * r + hh * hh)
            iyy = 0.5 * m_cyl * r * r + 0.4 * m_sph * r * r
            inertia = np.diag([ixx, iyy, ixx])
        else:
            mass = density * (4 * hh * r + np.pi * r * r)
            inertia = np.array([[mass * ((2 * r) ** 2 + (2 * hh + 2 * r) ** 2) / 12.0]])
        return mass, np.zeros(dim), inertia
    return np.inf, np.zeros(dim), None
