"""Channel-form analytic node CDF (port of
wgsparkl_tpu/collision/cdf_channel.py).

Cuboid, ball, capsule and halfspace colliders, in 2D and 3D, with the JAX
package's operation order (the ball's and the capsule's reciprocal is an
IEEE division, `math.div`).  `node_cdf_channels` skips mesh slots (their
node CDF is the mesh pass, ops/rigid_cdf.py); `project` raises on a mesh
shape asked for directly.  Node positions are lists of [M] channels; body poses
and shape parameters enter as 0-d tensors.  Affinity words are int32
holding the uint32 bit pattern.
"""

from __future__ import annotations

import torch

from wgsparkl_tpu_torch.collision import shapes as shp
from wgsparkl_tpu_torch.math import div

BIG = 1.0e10


def bit(k: int) -> int:
    """int32 value of the uint32 word with only bit k set."""
    return -(1 << 31) if k == 31 else 1 << k


def _quat_rotate_ch(q, v):
    w, x, y, z = q[0], q[1], q[2], q[3]
    t0 = 2.0 * (y * v[2] - z * v[1])
    t1 = 2.0 * (z * v[0] - x * v[2])
    t2 = 2.0 * (x * v[1] - y * v[0])
    return [
        v[0] + w * t0 + (y * t2 - z * t1),
        v[1] + w * t1 + (z * t0 - x * t2),
        v[2] + w * t2 + (x * t1 - y * t0),
    ]


def _rot2_ch(r, v, inv=False):
    c, s = r[0], (-r[1] if inv else r[1])
    return [c * v[0] - s * v[1], s * v[0] + c * v[1]]


def _to_local(rot, trans, p):
    rel = [p[a] - trans[a] for a in range(len(p))]
    if len(p) == 2:
        return _rot2_ch(rot, rel, inv=True)
    return _quat_rotate_ch([rot[0], -rot[1], -rot[2], -rot[3]], rel)


def _to_world_vec(rot, v):
    return _rot2_ch(rot, v) if len(v) == 2 else _quat_rotate_ch(rot, v)


def _proj_cuboid(he, q):
    d = len(q)
    clamped = [torch.minimum(torch.maximum(q[a], -he[a]), he[a])
               for a in range(d)]
    inside = q[0].abs() < he[0]
    for a in range(1, d):
        inside = inside & (q[a].abs() < he[a])
    gaps = [he[a] - q[a].abs() for a in range(d)]
    min_gap = gaps[0]
    for a in range(1, d):
        min_gap = torch.minimum(min_gap, gaps[a])
    proj = []
    snapped = torch.zeros_like(inside)
    for a in range(d):
        sgn = torch.where(q[a] >= 0.0, 1.0, -1.0)
        is_min = (gaps[a] == min_gap) & ~snapped
        snapped = snapped | is_min
        proj.append(torch.where(inside & is_min, sgn * he[a], clamped[a]))
    return proj, inside


def _sqnorm(v):
    acc = v[0] * v[0]
    for a in range(1, len(v)):
        acc = acc + v[a] * v[a]
    return acc


def _proj_ball(radius, q):
    n = torch.sqrt(_sqnorm(q))
    away = n > 1e-12
    inv = torch.where(away, div(1.0, torch.clamp(n, min=1e-30)), 0.0)
    proj = [torch.where(away, q[a] * inv * radius, 0.0) for a in range(len(q))]
    # At the centre the projection is +x on the sphere.
    proj[0] = torch.where(away, proj[0], radius)
    return proj, n < radius


def _proj_capsule(hh, radius, q):
    """Axis along local y, from -hh to hh."""
    cy = torch.minimum(torch.maximum(q[1], -hh), hh)
    base = [cy if a == 1 else 0.0 for a in range(len(q))]
    rel = [q[a] - base[a] for a in range(len(q))]
    n = torch.sqrt(_sqnorm(rel))
    away = n > 1e-12
    inv = torch.where(away, div(1.0, torch.clamp(n, min=1e-30)), 0.0)
    # On the axis the projection leaves along +x.
    proj = [base[a] + torch.where(away, rel[a] * inv, 1.0 if a == 0 else 0.0)
            * radius for a in range(len(q))]
    return proj, n < radius


def _proj_halfspace(q):
    """Boundary the local y = 0 plane, inside y < 0."""
    return ([q[a] if a != 1 else torch.zeros_like(q[a]) for a in range(len(q))],
            q[1] < 0.0)


def project(shape_type, params, q):
    """Boundary projection of local points q (d channels) on one shape with
    parameters params (0-d tensors): (proj, inside)."""
    if shape_type == shp.SHAPE_CUBOID:
        return _proj_cuboid([params[a] for a in range(len(q))], q)
    if shape_type == shp.SHAPE_BALL:
        return _proj_ball(params[0], q)
    if shape_type == shp.SHAPE_CAPSULE:
        return _proj_capsule(params[0], params[1], q)
    if shape_type == shp.SHAPE_HALFSPACE:
        return _proj_halfspace(q)
    raise ValueError(
        f"collider shape {shape_type} is a mesh: its node CDF is the mesh pass "
        "(ops/rigid_cdf.py), not a boundary projection")


def merge_node_cdf(a, b):
    """Merge two node-CDF triples (dist, aff, closest) computed over
    disjoint collider subsets into what the index-ordered loop of
    node_cdf_channels gives over their union: strictly smaller distance
    wins, the lower collider index on exact ties, affinity words OR."""
    da, fa, ca = a
    db, fb, cb = b
    b_wins = (cb >= 0) & ((db < da) | ((db == da) & ((ca < 0) | (cb < ca))))
    return torch.where(b_wins, db, da), fa | fb, torch.where(b_wins, cb, ca)


def collider_cdf(shape_type, rot, trans, params, pos, cap):
    """One posed collider at d node channels (d = 2 or 3; rot a unit
    complex or a quaternion): (within, inside, world distance)."""
    d = len(pos)
    q = _to_local(rot, trans, pos)
    proj, inside = project(shape_type, params, q)
    dl = [proj[a] - q[a] for a in range(d)]
    dw = _to_world_vec(rot, dl)
    box = dw[0].abs() <= cap
    sq = dw[0] * dw[0]
    for a in range(1, d):
        box = box & (dw[a].abs() <= cap)
        sq = sq + dw[a] * dw[a]
    return inside | box, inside, torch.sqrt(sq)


def node_cdf_channels(collider_types, shape_params, rot, trans, pos,
                      cell_width, only=None):
    """pos: d node channels [M].  Returns (dist f32, aff int32, closest
    int32) over the analytic colliders in `only` (None = all), index order,
    strictly closer wins; mesh slots are skipped."""
    m = pos[0].shape[0]
    dev = pos[0].device
    dist = torch.full((m,), BIG, dtype=torch.float32, device=dev)
    aff = torch.zeros((m,), dtype=torch.int32, device=dev)
    closest = torch.full((m,), -1, dtype=torch.int32, device=dev)
    cap = 1.5 * cell_width
    for i, st in enumerate(collider_types):
        if st not in shp.ANALYTIC or (only is not None and i not in only):
            continue
        within, inside, di = collider_cdf(st, rot[i], trans[i], shape_params[i],
                                          pos, cap)
        closer = within & (di < dist)
        closest = torch.where(closer, i, closest)
        dist = torch.where(closer, di, dist)
        bits = torch.where(inside, bit(16 + i) | bit(i), bit(i))
        aff = aff | torch.where(within, bits, 0).to(torch.int32)
    return dist, aff, closest
