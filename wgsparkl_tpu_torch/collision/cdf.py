"""CPIC node and particle CDF on the dense grid (port of
wgsparkl_tpu/collision/cdf.py: the affinity-word helpers, `node_cdf`, the
explicit small solves and `particle_cdf_update`; kernel dense_pcdf, csrc/dense_pcdf.cu, computes the
update on the card).

The affinity word holds 16 affinity bits and, above them, 16 sign bits;
here it rides as int32 holding the uint32 bit pattern, masked after every
right shift.  `particle_cdf_update` is the plain version of the kernel and
spells its sums out in the kernel's order: stencil offsets in order (the
last axis fastest), the normal equations entry by entry as
(w p_i) p_j, the solves by the JAX package's explicit cofactor formulas,
so that the `det > 1e-8` decisions are the same.
"""

from __future__ import annotations

import torch

from wgsparkl_tpu_torch import _cuda
from wgsparkl_tpu_torch.collision import cdf_channel as cch
from wgsparkl_tpu_torch.math import div
from wgsparkl_tpu_torch.ops import rows as R
from wgsparkl_tpu_torch.ops import rows2d as R2
from wgsparkl_tpu_torch.ops.kernel import stencil_base_and_weights, stencil_offsets

AFFINITY_MASK = 0xFFFF
SIGN_SHIFT = 16
MAX_COLLIDERS = 16


def affinities_are_compatible(a1, a2):
    """Particle / node CPIC compatibility (grid.wgsl:250-255)."""
    common = a1 & a2 & AFFINITY_MASK
    return (((a1 >> SIGN_SHIFT) & AFFINITY_MASK) & common) == (
        ((a2 >> SIGN_SHIFT) & AFFINITY_MASK) & common)


def affinity_bit(i: int, aff):
    return (aff & (1 << i)) != 0


def sign_bit(i: int, aff):
    return ((aff >> SIGN_SHIFT) & (1 << i)) != 0


def node_cdf(collider_types, shape_params, rot, trans, points, cell_width,
             only=None):
    """Analytic node CDF at the points: (unsigned distance f32 [M], affinity
    word int32 [M], closest collider int32 [M], -1 for none).  points: [M,
    d] positions or d channels [M]; shape_params [B, 8], rot and trans the
    bodies' poses; mesh slots are skipped (they reach the node CDF through
    the mesh pass, ops/rigid_cdf.py), and with `only` (a set of slots) so
    is every other slot.  A collider within 1.5 cells of a node (or
    holding it) sets its affinity bit, and its sign bit where it holds the
    node; the strictly closest such collider is the node's closest, the
    lower slot on ties."""
    pos = list(points.unbind(-1)) if isinstance(points, torch.Tensor) else list(points)
    return cch.node_cdf_channels(collider_types, shape_params, rot, trans, pos,
                                 cell_width, only=only)


def _apply(adj, b, det):
    """x_i = (sum_j adj[i][j] b_j) * inv_det, j in order; inv_det 0 where
    |det| <= 1e-30."""
    inv_det = torch.where(torch.abs(det) > 1e-30, div(1.0, det), 0.0)
    out = []
    for row in adj:
        acc = row[0] * b[0]
        for j in range(1, len(b)):
            acc = acc + row[j] * b[j]
        out.append(acc * inv_det)
    return out


def _inv3_apply(a, b):
    """(inv(a) b, det) for a 3 x 3 system by its adjugate; a: rows of
    lists of [N] tensors, b: a list."""
    c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2]
    c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02
    c10 = a[0][2] * a[2][1] - a[0][1] * a[2][2]
    c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0]
    c12 = a[0][1] * a[2][0] - a[0][0] * a[2][1]
    c20 = a[0][1] * a[1][2] - a[0][2] * a[1][1]
    c21 = a[0][2] * a[1][0] - a[0][0] * a[1][2]
    c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0]
    adj = [[c00, c10, c20], [c01, c11, c21], [c02, c12, c22]]
    return _apply(adj, b, det), det


def _inv4_apply(a, b):
    """(inv(a) b, det) for a 4 x 4 system by the 2 x 2 block cofactors."""
    s0 = a[0][0] * a[1][1] - a[1][0] * a[0][1]
    s1 = a[0][0] * a[1][2] - a[1][0] * a[0][2]
    s2 = a[0][0] * a[1][3] - a[1][0] * a[0][3]
    s3 = a[0][1] * a[1][2] - a[1][1] * a[0][2]
    s4 = a[0][1] * a[1][3] - a[1][1] * a[0][3]
    s5 = a[0][2] * a[1][3] - a[1][2] * a[0][3]
    c5 = a[2][2] * a[3][3] - a[3][2] * a[2][3]
    c4 = a[2][1] * a[3][3] - a[3][1] * a[2][3]
    c3 = a[2][1] * a[3][2] - a[3][1] * a[2][2]
    c2 = a[2][0] * a[3][3] - a[3][0] * a[2][3]
    c1 = a[2][0] * a[3][2] - a[3][0] * a[2][2]
    c0 = a[2][0] * a[3][1] - a[3][0] * a[2][1]
    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    adj = [
        [a[1][1] * c5 - a[1][2] * c4 + a[1][3] * c3,
         -a[0][1] * c5 + a[0][2] * c4 - a[0][3] * c3,
         a[3][1] * s5 - a[3][2] * s4 + a[3][3] * s3,
         -a[2][1] * s5 + a[2][2] * s4 - a[2][3] * s3],
        [-a[1][0] * c5 + a[1][2] * c2 - a[1][3] * c1,
         a[0][0] * c5 - a[0][2] * c2 + a[0][3] * c1,
         -a[3][0] * s5 + a[3][2] * s2 - a[3][3] * s1,
         a[2][0] * s5 - a[2][2] * s2 + a[2][3] * s1],
        [a[1][0] * c4 - a[1][1] * c2 + a[1][3] * c0,
         -a[0][0] * c4 + a[0][1] * c2 - a[0][3] * c0,
         a[3][0] * s4 - a[3][1] * s2 + a[3][3] * s0,
         -a[2][0] * s4 + a[2][1] * s2 - a[2][3] * s0],
        [-a[1][0] * c3 + a[1][1] * c1 - a[1][2] * c0,
         a[0][0] * c3 - a[0][1] * c1 + a[0][2] * c0,
         -a[3][0] * s3 + a[3][1] * s1 - a[3][2] * s0,
         a[2][0] * s3 - a[2][1] * s1 + a[2][2] * s0],
    ]
    return _apply(adj, b, det), det


def solve_small(a, b):
    """Solve a x = b for the (d + 1) x (d + 1) normal equations: (x, det),
    a as rows of lists of [N] tensors, b and x lists."""
    if len(a) == 3:
        return _inv3_apply(a, b)
    if len(a) == 4:
        return _inv4_apply(a, b)
    raise ValueError(f"solve_small supports 3x3 / 4x4, got {len(a)}")


def particle_cdf_update(pos, prev_affinity, node_dist, node_aff, grid,
                        num_colliders: int):
    """Per-particle CDF reconstruction (g2p_cdf.wgsl:157-249): the union of
    the stencil nodes' affinity bits, a sign vote per collider (the sum over
    nodes carrying its bit of w * (+-1) * dist; a collider the particle was
    already affine to keeps its sign), then the signed distance and normal
    by weighted least squares over the nodes sharing affinity with the
    particle.  pos [N, d], prev_affinity [N] int32, node_dist [M] f32 and
    node_aff [M] int32 over the row-major grid.  Returns dict(normal [N, d],
    signed_distance [N], affinity [N] int32); a degenerate fit (det <=
    1e-8) gives zeros."""
    n, d = pos.shape
    base, w, dpt = stencil_base_and_weights(pos, grid.cell_width)
    offs = torch.as_tensor(stencil_offsets(d), device=pos.device)
    cells = base[:, None, :] + offs[None]
    valid = grid.in_bounds(cells)
    flat = torch.where(valid, grid.flatten_index(cells), 0).long()
    n_aff = torch.where(valid, node_aff[flat], 0)
    n_dist = torch.where(valid, node_dist[flat], 0.0)
    kk = range(offs.shape[0])

    or_all = torch.zeros_like(prev_affinity)
    votes = [torch.zeros(n, dtype=torch.float32, device=pos.device)
             for _ in range(num_colliders)]
    for k in kk:
        a = n_aff[:, k]
        or_all = or_all | a
        wd = w[:, k] * n_dist[:, k]
        for c in range(num_colliders):
            term = torch.where(((a >> (SIGN_SHIFT + c)) & 1) != 0, -wd, wd)
            votes[c] = votes[c] + torch.where(((a >> c) & 1) != 0, term, 0.0)
    sign_word = torch.zeros_like(prev_affinity)
    for c in range(num_colliders):
        keep = affinity_bit(c, prev_affinity)
        s = torch.where(keep, sign_bit(c, prev_affinity), votes[c] < 0.0)
        sign_word = sign_word | (s.to(torch.int32) << c)
    p_aff = (or_all & AFFINITY_MASK) | (sign_word << SIGN_SHIFT)

    zero = torch.zeros(n, dtype=torch.float32, device=pos.device)
    qtq = [[zero] * (d + 1) for _ in range(d + 1)]
    qtu = [zero] * (d + 1)
    p_hi = (p_aff >> SIGN_SHIFT) & AFFINITY_MASK
    for k in kk:
        a = n_aff[:, k]
        combined = a & p_aff & AFFINITY_MASK
        sign_diff = (((a >> SIGN_SHIFT) & AFFINITY_MASK) ^ p_hi) & combined
        sdist = torch.where(sign_diff == 0, n_dist[:, k], -n_dist[:, k])
        wk = torch.where(combined != 0, w[:, k], 0.0)
        pv = [dpt[:, k, i] for i in range(d)] + [torch.ones_like(zero)]
        for i in range(d + 1):
            wp = wk * pv[i]
            for j in range(d + 1):
                qtq[i][j] = qtq[i][j] + wp * pv[j]
            qtu[i] = qtu[i] + (wk * sdist) * pv[i]
    sol, det = solve_small(qtq, qtu)
    ok = det > 1e-8
    nlen = sol[0] * sol[0]
    for i in range(1, d):
        nlen = nlen + sol[i] * sol[i]
    nlen = torch.sqrt(nlen)
    normal = torch.stack([torch.where(ok & (nlen > 1e-6),
                                      sol[i] / torch.clamp(nlen, min=1e-30), 0.0)
                          for i in range(d)], -1)
    return {"normal": normal, "signed_distance": torch.where(ok, sol[d], 0.0),
            "affinity": torch.where(ok, p_aff, 0)}


def _aff_rows(d: int):
    return (R.AFF, R.AFF_SPARE) if d == 3 else (R2.AFF, R2.AFF_SPARE)


def pcdf_rows_plain(rows, n: int, node_dist, node_aff, grid, nc: int):
    """Plain version of dense_pcdf: particle_cdf_update on the first n lanes
    of the rows, as [8, NPAD] particle-CDF rows."""
    d = grid.dim
    lo, hi = _aff_rows(d)
    prev = R.aff_from_halves(rows[lo, :n], rows[hi, :n])
    out = particle_cdf_update(rows[:d, :n].T, prev, node_dist, node_aff, grid, nc)
    pcdf = torch.zeros((8, rows.shape[1]), dtype=torch.float32, device=rows.device)
    a_lo, a_hi = R.aff_halves(out["affinity"])
    pcdf[0, :n] = a_lo
    pcdf[1, :n] = out["signed_distance"]
    pcdf[2:2 + d, :n] = out["normal"].T
    pcdf[2 + d, :n] = a_hi
    return pcdf


def dense_pcdf(rows, n: int, node_dist, node_aff, grid, nc: int):
    """Particle-CDF rows [8, NPAD] (aff low, signed distance, normal, aff
    high; the other rows and the lanes >= n zero) of the particles on the
    first n lanes of the [PCHAN, NPAD] rows (3D, or the 2D rows), against
    the row-major node CDF (node_dist f32, node_aff int32 [M]): one launch
    of kernel dense_pcdf on the card, particle_cdf_update on the CPU."""
    if rows.device.type == "cpu":
        return pcdf_rows_plain(rows, n, node_dist, node_aff, grid, nc)
    d = grid.dim
    if node_dist.dtype != torch.float32 or node_aff.dtype != torch.int32 \
            or node_dist.shape != (grid.num_nodes,) or node_aff.shape != node_dist.shape:
        raise ValueError("dense_pcdf: node_dist f32 and node_aff int32 [M]")
    if not 0 < nc <= MAX_COLLIDERS or rows.dtype != torch.float32:
        raise ValueError("dense_pcdf: f32 rows and 1-16 colliders")
    R.check_kernel_args(rows, node_dist, node_aff)
    out = torch.empty((8, rows.shape[1]), dtype=torch.float32, device=rows.device)
    shape = tuple(grid.shape) + (1,) * (3 - d)
    origin = tuple(grid.origin_cell) + (0,) * (3 - d)
    _cuda.launch("dense_pcdf", f"dense_pcdf{d}d_cuda", "piipp" + "i" * 7 + "fp",
                 rows, rows.shape[1], n, node_dist, node_aff, *shape, *origin, nc,
                 R.f32(grid.cell_width), out)
    dense_pcdf.launches += 1
    return out


dense_pcdf.launches = 0
