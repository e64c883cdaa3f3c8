"""Body-body contacts (port of wgsparkl_tpu/rigid/contacts.py): velocity-
level sequential impulses with Coulomb friction and a Baumgarte positional
bias, Gauss-Seidel over every ordered pair of a dynamic body and another
analytic collider, dynamic-dynamic pairs included.

Contact samples are the JAX package's: a dynamic cuboid's 2^d corners (in
3D also three points on each of its 12 edges), a ball's deepest point
towards the other collider, a capsule's two cap centres as balls.  The
sweeps run in the JAX package's order: sweeps outermost, then the pairs,
then each pair's samples.  A sample whose depth is not positive is skipped
(the JAX package adds zero impulses there: the same up to the sign of a
zero).

This is the plain PyTorch version of the contact half of the rigid-solve
kernel (csrc/rigid_solve.cu, wrapped by rigid/solve.py).  Its arithmetic is
written operation by operation in the kernel's order (every sum of a dot,
cross or matrix product spelled out), so that on the card the kernel equals
it bit for bit; candidates are computed per pair over its samples at once,
the impulse loop on 0-d tensors.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from wgsparkl_tpu_torch.collision import cdf_channel as cch
from wgsparkl_tpu_torch.collision import shapes as shp
from wgsparkl_tpu_torch.math import div

CONTACT_BETA = 0.2      # Baumgarte positional-correction factor
CONTACT_FRICTION = 0.4
CONTACT_ITERATIONS = 4  # Gauss-Seidel sweeps over all pairs
DYNAMIC_SHAPES = (shp.SHAPE_CUBOID, shp.SHAPE_BALL, shp.SHAPE_CAPSULE)


def _corner_offsets(dim: int) -> np.ndarray:
    """[2^d, d] unit corner signs of a cuboid."""
    corners = np.stack(np.meshgrid(*([np.array([-1.0, 1.0])] * dim), indexing="ij"),
                       -1).reshape(-1, dim)
    return corners.astype(np.float32)


def _cuboid_sample_offsets(dim: int) -> np.ndarray:
    """Unit-cube contact samples: the corners, and in 3D three interior
    points of each edge (edge-edge crossings hold no corner)."""
    pts = [_corner_offsets(dim)]
    if dim == 3:
        edge = []
        for axis in range(3):
            others = [a for a in range(3) if a != axis]
            for s0 in (-1.0, 1.0):
                for s1 in (-1.0, 1.0):
                    for t in (-0.5, 0.0, 0.5):
                        p = np.zeros(3)
                        p[axis], p[others[0]], p[others[1]] = t, s0, s1
                        edge.append(p)
        pts.append(np.asarray(edge))
    return np.concatenate(pts, 0).astype(np.float32)


def sample_count(shape_type: int, dim: int) -> int:
    """Contact samples of a dynamic body of this shape against a collider."""
    if shape_type == shp.SHAPE_CUBOID:
        return len(_cuboid_sample_offsets(dim))
    return 1 if shape_type == shp.SHAPE_BALL else 2


def contact_pairs(collider_types: Sequence[int], dynamic_slots: Sequence[int],
                  skip_pairs=frozenset()):
    """The ordered pairs (b, bt, c, ct, two_way) of the contact pass: each
    dynamic cuboid, ball or capsule b against every other analytic
    collider c not jointed to it; two_way when c is dynamic too."""
    dyn = set(dynamic_slots)
    pairs = []
    for b in dynamic_slots:
        bt = collider_types[b]
        if bt not in DYNAMIC_SHAPES:
            continue
        for c, ct in enumerate(collider_types):
            if c == b or ct not in shp.ANALYTIC:
                continue
            if (b, c) in skip_pairs or (c, b) in skip_pairs:
                continue
            pairs.append((b, bt, c, ct, c in dyn))
    return pairs


# ---- small vector algebra on lists of 0-d tensors or [S] channels, in the
# kernel's order of operations ----
def _dot(a, b):
    acc = a[0] * b[0]
    for i in range(1, len(a)):
        acc = acc + a[i] * b[i]
    return acc


def _cross(a, b):
    """3D cross product; in 2D the scalar cross as a 1-list."""
    if len(a) == 2:
        return [a[0] * b[1] - a[1] * b[0]]
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _avel(w, r):
    """Velocity of angular velocity w at lever r."""
    if len(r) == 2:
        return [-w[0] * r[1], w[0] * r[0]]
    return _cross(w, r)


def _matvec(m, v):
    return [_dot(row, v) for row in m]


def _wsum(v, w):
    """sum_a (v_a * v_a) * w_a: a squared direction weighted per axis."""
    acc = (v[0] * v[0]) * w[0]
    for i in range(1, len(v)):
        acc = acc + (v[i] * v[i]) * w[i]
    return acc


def _norm(v):
    return torch.sqrt(_dot(v, v))


def _add(a, b):
    return [x + y for x, y in zip(a, b)]


def _sub(a, b):
    return [x - y for x, y in zip(a, b)]


def _rows(t):
    """A tensor as nested lists of 0-d tensors (its leading axes unbound)."""
    if t.dim() == 0:
        return t
    return [_rows(r) for r in t.unbind(0)]


class BodyScalars:
    """The RigidWorld fields the solvers read, as nested lists of 0-d
    tensors by slot (bodies: fresh world_com and inv_inertia_world; linvel
    and angvel are the prescribed velocities of non-dynamic bodies)."""

    def __init__(self, bodies):
        self.dim = bodies.dim
        self.device = bodies.pos.device
        for f in ("rot", "pos", "world_com", "inv_mass", "inv_inertia_world",
                  "shape_params", "linvel", "angvel"):
            setattr(self, f, _rows(getattr(bodies, f)))
        self.zero = torch.zeros((), dtype=torch.float32, device=self.device)


def _transform(rot, trans, v):
    """World point of local v (channels or 0-d tensors) under (rot, trans)."""
    w = cch._to_world_vec(rot, v)
    return [w[a] + trans[a] for a in range(len(v))]


def _point_contacts(points, dpt, inside):
    """Cuboid samples: contact only when inside."""
    dist = _norm(dpt)
    safe = torch.clamp(dist, min=1e-12)
    normal = [x / safe for x in dpt]
    return points, normal, torch.where(inside, dist, -1.0)


def _ball_contacts(centers, radius, dpt, inside):
    """Ball samples of `radius` at centers: depth radius -/+ distance."""
    dist = _norm(dpt)
    safe = torch.clamp(dist, min=1e-12)
    dirn = [x / safe for x in dpt]
    normal = [torch.where(inside, x, -x) for x in dirn]
    depth = torch.where(inside, radius + dist, radius - dist)
    return [c + x for c, x in zip(centers, dpt)], normal, depth


def candidates(B: BodyScalars, b, bt, c, ct, offsets=None):
    """(points, normals, depths) channels [S] of body b's samples against
    collider c; offsets: the cuboid sample offsets [S, d] on the device."""
    dim = B.dim
    sp = B.shape_params
    if bt == shp.SHAPE_CUBOID:
        if offsets is None:
            offsets = torch.as_tensor(_cuboid_sample_offsets(dim), device=B.device)
        local = [offsets[:, a] * sp[b][a] for a in range(dim)]
        pts = _transform(B.rot[b], B.pos[b], local)
        return _point_contacts(pts, *shp.project_on_boundary_ch(ct, sp[c], B.rot[c],
                                                                B.pos[c], pts))
    if bt == shp.SHAPE_BALL:
        radius = sp[b][0]
        centers = [x.reshape(1) for x in B.world_com[b]]
    else:
        hh, radius = sp[b][0], sp[b][1]
        z = torch.zeros(2, dtype=torch.float32, device=B.device)
        local = [z, torch.stack([hh, -hh])] + ([z] if dim == 3 else [])
        centers = _transform(B.rot[b], B.pos[b], local)
    return _ball_contacts(centers, radius, *shp.project_on_boundary_ch(
        ct, sp[c], B.rot[c], B.pos[c], centers))


def pair_terms(B: BodyScalars, pair, cand, dt: float, slop: float):
    """The pose-dependent terms of a pair's samples (channels [S]): levers
    r_b, r_c, their cross products with the normal, the normal effective
    mass k_n and the positional bias."""
    b, _, c, _, two_way = pair
    pts, n, depth = cand
    rb, rc = _sub(pts, B.world_com[b]), _sub(pts, B.world_com[c])
    rxn_b, rxn_c = _cross(rb, n), _cross(rc, n)
    k_n = _wsum(n, B.inv_mass[b]) + _dot(rxn_b, _matvec(B.inv_inertia_world[b], rxn_b))
    if two_way:
        k_n = (k_n + _wsum(n, B.inv_mass[c])) + _dot(
            rxn_c, _matvec(B.inv_inertia_world[c], rxn_c))
    bias = div(CONTACT_BETA * torch.clamp(depth - slop, min=0.0), dt)
    return dict(n=n, rb=rb, rc=rc, rxn_b=rxn_b, rxn_c=rxn_c, k_n=k_n, bias=bias,
                depth=depth)


def _take(t, s):
    return [x[s] for x in t] if isinstance(t, list) else t[s]


def contact_step(B: BodyScalars, V, W, pair, terms, s, friction: float):
    """One Gauss-Seidel impulse of sample s: normal impulse, then Coulomb
    friction against the updated velocities.  V, W: the velocity tables
    (lists by slot of lists of 0-d tensors), updated in place."""
    b, _, c, _, two_way = pair
    n, rb, rc = _take(terms["n"], s), _take(terms["rb"], s), _take(terms["rc"], s)
    rxn_b, rxn_c = _take(terms["rxn_b"], s), _take(terms["rxn_c"], s)
    im_b, im_c = B.inv_mass[b], B.inv_mass[c]
    ii_b, ii_c = B.inv_inertia_world[b], B.inv_inertia_world[c]

    def v_c():
        if two_way:
            return _add(V[c], _avel(W[c], rc))
        return _add(B.linvel[c], _avel(B.angvel[c], rc))

    vrel = _sub(_add(V[b], _avel(W[b], rb)), v_c())
    vn = _dot(vrel, n)
    jn = torch.clamp((-vn + terms["bias"][s]) / torch.clamp(terms["k_n"][s], min=1e-12),
                     min=0.0)
    V[b] = [v + (jn * x) * m for v, x, m in zip(V[b], n, im_b)]
    W[b] = _add(W[b], _matvec(ii_b, [x * jn for x in rxn_b]))
    if two_way:
        njn = -jn
        V[c] = [v + (njn * x) * m for v, x, m in zip(V[c], n, im_c)]
        W[c] = _add(W[c], _matvec(ii_c, [x * njn for x in rxn_c]))

    vrel = _sub(_add(V[b], _avel(W[b], rb)), v_c())
    vn = _dot(vrel, n)
    vt = [v - vn * x for v, x in zip(vrel, n)]
    vt_len = _norm(vt)
    safe = torch.clamp(vt_len, min=1e-12)
    t_hat = [x / safe for x in vt]
    rxt_b, rxt_c = _cross(rb, t_hat), _cross(rc, t_hat)
    k_t = _wsum(t_hat, im_b) + _dot(rxt_b, _matvec(ii_b, rxt_b))
    if two_way:
        k_t = (k_t + _wsum(t_hat, im_c)) + _dot(rxt_c, _matvec(ii_c, rxt_c))
    jt = torch.minimum(torch.clamp(vt_len / torch.clamp(k_t, min=1e-12), min=0.0),
                       friction * jn)
    jt = torch.where(vt_len > 1e-9, jt, 0.0)
    njt = -jt
    V[b] = [v + (njt * x) * m for v, x, m in zip(V[b], t_hat, im_b)]
    W[b] = _add(W[b], _matvec(ii_b, [x * njt for x in rxt_b]))
    if two_way:
        V[c] = [v + (jt * x) * m for v, x, m in zip(V[c], t_hat, im_c)]
        W[c] = _add(W[c], _matvec(ii_c, [x * jt for x in rxt_c]))


def resolve_contacts(B: BodyScalars, V, W, pairs, dt: float, slop: float,
                     friction: float = CONTACT_FRICTION,
                     iterations: int = CONTACT_ITERATIONS, offsets=None):
    """The JAX package's resolve_contacts on velocity tables V, W (lists by
    slot of lists of 0-d tensors, updated in place): pairs from
    contact_pairs (jointed pairs skipped there), B the bodies with fresh
    world_com and inv_inertia_world, slop the penetration allowed before
    the positional bias engages."""
    if not pairs:
        return
    work = []
    for pair in pairs:
        cand = candidates(B, pair[0], pair[1], pair[2], pair[3], offsets)
        terms = pair_terms(B, pair, cand, dt, slop)
        active = [s for s, a in enumerate((terms["depth"] > 0.0).tolist()) if a]
        work.append((pair, terms, active))
    for _ in range(iterations):
        for pair, terms, active in work:
            for s in active:
                contact_step(B, V, W, pair, terms, s, friction)


def velocity_tables(linvel, angvel):
    return _rows(linvel), _rows(angvel)


def stack_tables(V, W):
    return torch.stack([torch.stack(v) for v in V]), torch.stack([torch.stack(w) for w in W])
