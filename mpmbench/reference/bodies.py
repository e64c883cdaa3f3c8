"""The bodies of the reference: fixed or kinematic colliders' poses and
velocities, as state beside the particles'.

A body's state holds, per body, `pos` [B, d] (its translation, which is
also its centre of mass: every kind's local centre of mass is the body's
origin), `rot` [B, 4] (a unit quaternion w, x, y, z) in 3D or [B, 2] (cos,
sin) in 2D, `linvel` [B, d] and `angvel` [B, 3] or [B, 1]: the layout of
mpmbench/program.read_state.  A fixed body never moves.  A kinematic body
keeps its prescribed velocities, takes no impulse (its mass is infinite)
and, after each substep's particle update, advances in upstream's
(rapier's) order: its rotation turns by the scaled axis angvel dt about
its world centre of mass (a quaternion product, then normalised), then
its centre of mass moves by linvel dt.

Written in plain torch from those semantics, in whatever dtype the state
has (float64 for the reference, bfloat16 for the control).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def quaternion(dim: int, rotation) -> list:
    """The rotation of a configuration (a scaled axis in 3D, an angle in
    2D, None for the identity) as a unit quaternion [w, x, y, z] or a unit
    complex [cos, sin], in float64."""
    if dim == 2:
        a = 0.0 if rotation is None else float(rotation)
        return [math.cos(a), math.sin(a)]
    v = np.zeros(3) if rotation is None else np.asarray(rotation, np.float64)
    angle = float(np.linalg.norm(v))
    if angle == 0.0:
        return [1.0, 0.0, 0.0, 0.0]
    s = math.sin(0.5 * angle) / angle
    return [math.cos(0.5 * angle), *(s * v).tolist()]


def initial(colliders, dim: int, dtype, device) -> dict:
    """The bodies' state that the configuration states."""
    ang = 3 if dim == 3 else 1
    rows = {"pos": [list(c.translation) for c in colliders],
            "rot": [quaternion(dim, c.rotation) for c in colliders],
            "linvel": [list(c.linvel or [0.0] * dim) for c in colliders],
            "angvel": [list(c.angvel or [0.0] * ang) for c in colliders]}
    return {k: torch.tensor(v, dtype=torch.float64, device=device).reshape(len(colliders), -1)
            .to(dtype) for k, v in rows.items()}


def rotation_matrix(rot):
    """[B, d, d] rotation matrices of unit quaternions [B, 4] or unit
    complex numbers [B, 2], in their dtype."""
    if rot.shape[-1] == 2:
        c, s = rot[..., 0], rot[..., 1]
        return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    w, x, y, z = rot.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def pose(bodies: dict, b: int):
    """Body b's pose as a kind's node CDF takes it: (translation [d],
    rotation matrix [d, d]), float64 numpy."""
    t = bodies["pos"][b].double().cpu().numpy()
    r = rotation_matrix(bodies["rot"][b:b + 1].double())[0].cpu().numpy()
    return t, r


def velocity_at(bodies: dict, idx, x):
    """Velocity of the bodies idx [...] (slots >= 0) at world points x [...,
    d]: linvel + angvel x (x - centre of mass); in 2D angvel turns the
    lever by 90 degrees."""
    lin, ang = bodies["linvel"][idx], bodies["angvel"][idx]
    r = x - bodies["pos"][idx]
    if x.shape[-1] == 2:
        return lin + ang[..., :1] * torch.stack([-r[..., 1], r[..., 0]], -1)
    a0, a1, a2 = ang.unbind(-1)
    r0, r1, r2 = r.unbind(-1)
    return lin + torch.stack([a1 * r2 - a2 * r1, a2 * r0 - a0 * r2, a0 * r1 - a1 * r0], -1)


def _quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def advance(bodies: dict, kinematic, dt: float) -> dict:
    """The bodies after one substep: each kinematic one (kinematic [B]
    bool) rotated by angvel dt about its centre of mass and moved by
    linvel dt; fixed ones, and every velocity, as they were."""
    rot, ang = bodies["rot"], bodies["angvel"]
    if rot.shape[-1] == 2:
        a = ang[:, 0] * dt
        c, s = torch.cos(a), torch.sin(a)
        turned = torch.stack([c * rot[:, 0] - s * rot[:, 1], s * rot[:, 0] + c * rot[:, 1]], -1)
    else:
        v = ang * dt
        angle = torch.sqrt((v * v).sum(-1, keepdim=True))
        half = 0.5 * angle
        scale = torch.where(angle > 0, torch.sin(half) / torch.where(angle > 0, angle, 1.0),
                            torch.zeros_like(angle))
        turned = _quat_mul(torch.cat([torch.cos(half), scale * v], -1), rot)
    turned = turned / torch.sqrt((turned * turned).sum(-1, keepdim=True))
    k = kinematic[:, None]
    return {**bodies, "rot": torch.where(k, turned, rot),
            "pos": torch.where(k, bodies["pos"] + bodies["linvel"] * dt, bodies["pos"])}


def gap(a: dict, b: dict, h: float, dt: float) -> float:
    """The largest gap between two bodies' states in the units of the
    particles' numbers: position in cells, an entry of the rotation matrix
    (the quaternion has two signs), linear velocity in cells a substep,
    angular velocity times dt."""
    f = lambda x: x.to(torch.float64)  # noqa: E731
    parts = [(f(a["pos"]) - f(b["pos"])) / h,
             rotation_matrix(f(a["rot"])) - rotation_matrix(f(b["rot"])),
             (f(a["linvel"]) - f(b["linvel"])) * dt / h,
             (f(a["angvel"]) - f(b["angvel"])) * dt]
    return max(float(p.abs().max()) if p.numel() else 0.0 for p in parts)
