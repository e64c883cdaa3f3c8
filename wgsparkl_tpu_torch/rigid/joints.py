"""Joints between rigid bodies (port of wgsparkl_tpu/rigid/joints.py):
ball, fixed, revolute (3D) and prismatic, as velocity-level sequential
impulses with a Baumgarte bias on the anchor gap, solved with the exact
per-joint effective-mass matrix (closed-form 2 x 2 or 3 x 3 inverse) in
Gauss-Seidel sweeps.

Each joint holds the world velocity of an anchor fixed on body b equal to
that of an anchor fixed on body c.  fixed also locks the relative rotation
at its value when the scene was built; revolute (3D) leaves only the
rotation about a hinge axis free; prismatic locks the relative rotation and
leaves only translation along an axis fixed in b's frame free.  Bodies with
zero inverse mass (fixed, kinematic) are valid anchors with a prescribed
velocity.  Joints are the normalised static tuples of
`pipeline._normalize_joints`: (b, c, anchor_b, anchor_c, kind, extra).

A body is dynamic here when its inverse mass is not zero.  In 2D the
angular velocity is a scalar: the JAX package broadcasts its [2] per-axis
dynamic mask against the [1] angular velocity there and fails on every 2D
joint; this port takes the one flag a body.

This is the plain PyTorch version of the joint half of the rigid-solve
kernel (csrc/rigid_solve.cu): the pose-dependent terms of each joint are
computed once a call (`joint_terms`), then the sweeps apply them
(`joint_step`), every operation in the kernel's order.
"""

from __future__ import annotations

import numpy as np
import torch

from wgsparkl_tpu_torch.collision.cdf_channel import _quat_rotate_ch, _to_world_vec
from wgsparkl_tpu_torch.math import div
from wgsparkl_tpu_torch.rigid.contacts import (
    BodyScalars, _add, _avel, _cross, _dot, _matvec, _norm, _sub, _transform,
)

JOINT_BETA = 0.2        # Baumgarte positional-correction factor
JOINT_ITERATIONS = 8    # Gauss-Seidel sweeps over all joints
KINDS = {"ball": 0, "fixed": 1, "revolute": 2, "prismatic": 3}


def beta_over_dt(dt: float, beta: float = JOINT_BETA) -> float:
    """beta / dt divided in f32, as the JAX package divides it."""
    return float(np.float32(beta) / np.float32(dt))


def _inv2(k):
    det = k[0][0] * k[1][1] - k[0][1] * k[1][0]
    inv_det = torch.where(det.abs() > 1e-12, div(1.0, det), 0.0)
    return [[inv_det * k[1][1], inv_det * -k[0][1]],
            [inv_det * -k[1][0], inv_det * k[0][0]]]


def _inv3(k):
    c = [_cross(k[1], k[2]), _cross(k[2], k[0]), _cross(k[0], k[1])]
    det = _dot(k[0], c[0])
    inv_det = torch.where(det.abs() > 1e-12, div(1.0, det), 0.0)
    return [[inv_det * c[j][i] for j in range(3)] for i in range(3)]


def _vecmat(v, m):
    """Row vector v times matrix m."""
    return [_dot(v, [m[i][j] for i in range(len(v))]) for j in range(len(m[0]))]


def _matmul(a, b):
    return [[_dot(a[i], [b[k][j] for k in range(len(b))]) for j in range(len(b[0]))]
            for i in range(len(a))]


def _skew_k(ii, r, zero):
    """-[r]x I^-1 [r]x as an explicit d x d matrix (the rotational part of
    the point effective mass)."""
    if len(r) == 2:
        i0 = ii[0][0]
        return [[i0 * (r[1] * r[1]), i0 * (-r[0] * r[1])],
                [i0 * (-r[0] * r[1]), i0 * (r[0] * r[0])]]
    nz = -zero
    neg_rx = [[nz, r[2], -r[1]], [-r[2], nz, r[0]], [r[1], -r[0], nz]]
    rx = [[zero, -r[2], r[1]], [r[2], zero, -r[0]], [-r[1], r[0], zero]]
    return _matmul(_matmul(neg_rx, ii), rx)


def _quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return [w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2]


def _conj(q):
    return [q[0]] + [-x for x in q[1:]]


def _rot2_mul(a, b):
    return [a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]]


def _tangents(a, zero):
    """Unit t1 perpendicular to a and t2 = a x t1 (from x, or from y when
    a is nearly along x)."""
    one = zero + 1.0
    near_x = a[0].abs() < 0.9
    h = [torch.where(near_x, one, zero), torch.where(near_x, zero, one), zero]
    t1 = _cross(a, h)
    nrm = torch.clamp(_norm(t1), min=1e-12)
    t1 = [x / nrm for x in t1]
    return t1, _cross(a, t1)


def _k2(t1, t2, k):
    """[[t1 k t1, t1 k t2], [t2 k t1, t2 k t2]] with (t k) formed first."""
    a, b = _vecmat(t1, k), _vecmat(t2, k)
    return [[_dot(a, t1), _dot(a, t2)], [_dot(b, t1), _dot(b, t2)]]


def joint_terms(B: BodyScalars, j, jf, bdt):
    """The pose-dependent terms of joint j = (b, c, kind) with its row jf of
    0-d tensors: anchors la_b [0:3], la_c [3:6], axis [6:9] (prismatic
    slide axis or revolute axis in b's frame), revolute axis in c's frame
    [9:12], initial relative rotation [12:16]; bdt: beta / dt (0-d)."""
    b, c, kind = j
    dim, zero = B.dim, B.zero
    a_b = _transform(B.rot[b], B.pos[b], jf[0:dim])
    a_c = _transform(B.rot[c], B.pos[c], jf[3:3 + dim])
    rb, rc = _sub(a_b, B.world_com[b]), _sub(a_c, B.world_com[c])
    im_b, im_c = B.inv_mass[b], B.inv_mass[c]
    t = dict(rb=rb, rc=rc, bias=[bdt * (x - y) for x, y in zip(a_b, a_c)],
             dyn_b=bool(im_b[0] != 0.0), dyn_c=bool(im_c[0] != 0.0))
    k = [[(im_b[j2] + im_c[j2]) * (zero + (1.0 if i == j2 else 0.0))
          for j2 in range(dim)] for i in range(dim)]
    for ii, r in ((B.inv_inertia_world[b], rb), (B.inv_inertia_world[c], rc)):
        s = _skew_k(ii, r, zero)
        k = [[k[i][j2] + s[i][j2] for j2 in range(dim)] for i in range(dim)]
    if kind == KINDS["prismatic"]:
        a_w = _to_world_vec(B.rot[b], jf[6:6 + dim])
        if dim == 2:
            t1 = [-a_w[1], a_w[0]]
            t["t1"], t["k1"] = t1, _dot(t1, _matvec(k, t1))
        else:
            t1, t2 = _tangents(a_w, zero)
            t["t1"], t["t2"], t["kinv"] = t1, t2, _inv2(_k2(t1, t2, k))
    else:
        t["kinv"] = _inv2(k) if dim == 2 else _inv3(k)
    if kind == KINDS["ball"]:
        return t
    ii_b, ii_c = B.inv_inertia_world[b], B.inv_inertia_world[c]
    rel0 = jf[12:14] if dim == 2 else jf[12:16]
    if dim == 2:
        rel = _rot2_mul([B.rot[b][0], -B.rot[b][1]], B.rot[c])
        err = _rot2_mul(rel, [rel0[0], -rel0[1]])[1]
        t["ang_bias"], t["ang_k"] = [bdt * err], ii_b[0][0] + ii_c[0][0]
        return t
    ksum = [[ii_b[i][j2] + ii_c[i][j2] for j2 in range(3)] for i in range(3)]
    if kind == KINDS["revolute"]:
        ax_b = _quat_rotate_ch(B.rot[b], jf[6:9])
        ax_c = _quat_rotate_ch(B.rot[c], jf[9:12])
        t1, t2 = _tangents(ax_b, zero)
        err = [-x for x in _cross(ax_c, ax_b)]
        t["ang_t1"], t["ang_t2"] = t1, t2
        t["ang_kinv"] = _inv2(_k2(t1, t2, ksum))
    else:
        q_err = _quat_mul(_quat_mul(_conj(B.rot[b]), B.rot[c]), _conj(rel0))
        two_sign = 2.0 * torch.sign(q_err[0])
        err = _quat_rotate_ch(B.rot[b], [two_sign * x for x in q_err[1:4]])
        t["ang_kinv"] = _inv3(ksum)
    t["ang_bias"] = [bdt * x for x in err]
    return t


def joint_step(B: BodyScalars, V, W, j, t):
    """One Gauss-Seidel pass of joint j = (b, c, kind) with its terms t:
    the anchor impulse, then (fixed, revolute, prismatic) the angular one.
    V, W updated in place."""
    b, c, kind = j
    rb, rc, dyn_b, dyn_c = t["rb"], t["rc"], t["dyn_b"], t["dyn_c"]
    v_b = (_add(V[b], _avel(W[b], rb)) if dyn_b
           else _add(B.linvel[b], _avel(B.angvel[b], rb)))
    v_c = (_add(V[c], _avel(W[c], rc)) if dyn_c
           else _add(B.linvel[c], _avel(B.angvel[c], rc)))
    v_err = _add(_sub(v_b, v_c), t["bias"])
    if kind == KINDS["prismatic"] and len(rb) == 2:
        t1, k1 = t["t1"], t["k1"]
        p1 = -torch.where(k1 > 1e-12, _dot(t1, v_err) / torch.clamp(k1, min=1e-30),
                          0.0)
        imp = [p1 * x for x in t1]
    elif kind == KINDS["prismatic"]:
        t1, t2 = t["t1"], t["t2"]
        p2 = [-x for x in _matvec(t["kinv"], [_dot(t1, v_err), _dot(t2, v_err)])]
        imp = [p2[0] * x + p2[1] * y for x, y in zip(t1, t2)]
    else:
        imp = [-x for x in _matvec(t["kinv"], v_err)]
    if dyn_b:
        V[b] = [v + x * m for v, x, m in zip(V[b], imp, B.inv_mass[b])]
        W[b] = _add(W[b], _matvec(B.inv_inertia_world[b], _cross(rb, imp)))
    if dyn_c:
        nimp = [-x for x in imp]
        V[c] = [v + x * m for v, x, m in zip(V[c], nimp, B.inv_mass[c])]
        W[c] = _add(W[c], _matvec(B.inv_inertia_world[c], _cross(rc, nimp)))
    if kind == KINDS["ball"] or (kind == KINDS["revolute"] and len(rb) == 2):
        return
    w_b = W[b] if dyn_b else B.angvel[b]
    w_c = W[c] if dyn_c else B.angvel[c]
    r = _add(_sub(w_c, w_b), t["ang_bias"])
    if len(rb) == 2:
        k = t["ang_k"]
        p = [-torch.where(k > 1e-12, r[0] / torch.clamp(k, min=1e-30), 0.0)]
    elif kind == KINDS["revolute"]:
        t1, t2 = t["ang_t1"], t["ang_t2"]
        p2 = [-x for x in _matvec(t["ang_kinv"], [_dot(t1, r), _dot(t2, r)])]
        p = [p2[0] * x + p2[1] * y for x, y in zip(t1, t2)]
    else:
        p = [-x for x in _matvec(t["ang_kinv"], r)]
    if dyn_c:
        W[c] = _add(W[c], _matvec(B.inv_inertia_world[c], p))
    if dyn_b:
        W[b] = _add(W[b], [-x for x in _matvec(B.inv_inertia_world[b], p)])


def joint_table(joints, dim: int, device):
    """(index rows [(b, c, kind)], float table [J, 16]) of normalised
    joints: la_b, la_c, axis, axis in c's frame, relative rotation (see
    joint_terms)."""
    rows, f = [], np.zeros((len(joints), 16), np.float32)
    for i, jt in enumerate(joints):
        b, c, la_b, la_c = jt[:4]
        kind = jt[4] if len(jt) > 4 else "ball"
        extra = jt[5] if len(jt) > 5 else None
        rows.append((int(b), int(c), KINDS[kind]))
        f[i, 0:dim], f[i, 3:3 + dim] = la_b, la_c
        if kind == "fixed":
            f[i, 12:12 + len(extra)] = extra
        elif kind == "revolute":
            f[i, 6:9], f[i, 9:12] = extra
        elif kind == "prismatic":
            f[i, 6:6 + dim] = extra[0]
            f[i, 12:12 + len(extra[1])] = extra[1]
    return rows, torch.as_tensor(f, device=device)


def resolve_joints(B: BodyScalars, V, W, rows, jtable, dt: float,
                   beta: float = JOINT_BETA, iterations: int = JOINT_ITERATIONS):
    """The JAX package's resolve_joints on velocity tables V, W (updated in
    place); rows and jtable from joint_table; B the bodies with the
    integrated poses and fresh world_com and inv_inertia_world."""
    if not rows:
        return
    bdt = B.zero + beta_over_dt(dt, beta)
    jf = [[x for x in r.unbind(0)] for r in jtable.unbind(0)]
    terms = [joint_terms(B, j, f, bdt) for j, f in zip(rows, jf)]
    for _ in range(iterations):
        for j, t in zip(rows, terms):
            joint_step(B, V, W, j, t)
