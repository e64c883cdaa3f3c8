"""Batched poses (port of wgsparkl_tpu/math/pose.py).

Rotation: quaternion [..., 4] ordered (w, x, y, z) in 3D, unit complex
[..., 2] ordered (cos, sin) in 2D; translation [..., d].  Norms are
sqrt(sum of squares), as jnp.linalg.norm computes them.
"""

import torch

from wgsparkl_tpu_torch.device import resolve


def quat_identity(shape=(), dtype=torch.float32, device=None):
    """Identity quaternions [*shape, 4] on `device` (None: the card)."""
    q = torch.zeros((*shape, 4), dtype=dtype, device=resolve(device))
    q[..., 0] = 1.0
    return q


def quat_from_axis_angle(axis, angle):
    """Quaternions of rotations by angle [...] about axis [..., 3] (normalised
    here)."""
    axis = axis / torch.clamp(_norm(axis), min=1e-12)
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None], axis * torch.sin(half)[..., None]],
                     dim=-1)


def rot2_identity(shape=(), dtype=torch.float32, device=None):
    """Identity rotations [*shape, 2] (cos, sin) on `device` (None: the
    card)."""
    r = torch.zeros((*shape, 2), dtype=dtype, device=resolve(device))
    r[..., 0] = 1.0
    return r


def rot_identity(dim, shape=(), dtype=torch.float32, device=None):
    """Identity rotations of a dim-D pose on `device` (None: the card):
    quaternions in 3D, unit complex numbers in 2D."""
    return (quat_identity if dim == 3 else rot2_identity)(shape, dtype, device)


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def quat_mul(q1, q2):
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_normalize(q):
    return q / torch.clamp(_norm(q), min=1e-12)


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def _cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def quat_rotate(q, v):
    """Rotate vectors v [..., 3] by quaternions q [..., 4]."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * _cross(qv, v)
    return v + w * t + _cross(qv, t)


def quat_inv_rotate(q, v):
    return quat_rotate(quat_conj(q), v)


def quat_from_scaled_axis(w):
    """exp map: rotation vector [..., 3] -> quaternion (stable near 0)."""
    angle = _norm(w)
    half = 0.5 * angle
    small = angle < 1e-8
    sinc = torch.where(small, 0.5, torch.sin(half) / torch.where(small, 1.0, angle))
    return quat_normalize(torch.cat([torch.cos(half), w * sinc], dim=-1))


def quat_to_matrix(q):
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(*q.shape[:-1], 3, 3)


def rot2_from_angle(angle):
    return torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)


def rot2_mul(r1, r2):
    c1, s1 = r1[..., 0], r1[..., 1]
    c2, s2 = r2[..., 0], r2[..., 1]
    return torch.stack([c1 * c2 - s1 * s2, c1 * s2 + s1 * c2], dim=-1)


def rot2_rotate(r, v):
    c, s = r[..., :1], r[..., 1:2]
    x, y = v[..., :1], v[..., 1:2]
    return torch.cat([c * x - s * y, s * x + c * y], dim=-1)


def rot2_inv_rotate(r, v):
    return rot2_rotate(torch.stack([r[..., 0], -r[..., 1]], dim=-1), v)


def rot2_normalize(r):
    return r / torch.clamp(_norm(r), min=1e-12)


def rotate(rot, v):
    """Rotate v [..., d] by a quaternion (d = 3) or unit complex (d = 2)."""
    return quat_rotate(rot, v) if v.shape[-1] == 3 else rot2_rotate(rot, v)


def inv_rotate(rot, v):
    return quat_inv_rotate(rot, v) if v.shape[-1] == 3 else rot2_inv_rotate(rot, v)


def transform_point(rot, trans, p):
    return rotate(rot, p) + trans


def inv_transform_point(rot, trans, p):
    """The inverse pose applied to p: rot^-1 (p - trans)."""
    return inv_rotate(rot, p - trans)
