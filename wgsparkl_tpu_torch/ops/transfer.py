"""The dense transfer: P2G, grid update and G2P on the whole row-major node
grid (port of wgsparkl_tpu/ops/transfer.py, the JAX package's reference
path and correctness oracle; kernels dense_p2g and dense_g2p,
csrc/dense_p2g.cu and csrc/dense_g2p.cu, compute P2G and G2P on the card).

Both take the particles as the [PCHAN, NPAD] rows (3D, or the 2D rows: in
either, position rows 0..d-1, velocity d..2d-1, mass 2d, the affine matrix
from 2d + 1) and the [8, NPAD] particle-CDF rows of collision/cdf.py (the
new affinity word and normal); the lanes below n and below `live` (a 0-d
int32 tensor, the blocked transfer's lane mask) take part.

P2G sums in a fixed order, with no atomics: one thread a node walks its
stencil offsets in order (the last axis fastest) and, within each, the
lanes whose stencil base cell is the node minus the offset, in lane order
(a stable sort of the lanes by base cell, glue).  The CPIC impulses of the
incompatible pairs are summed per node in the same walk, then per body over
each 256-node block by a shared-memory tree, then over the blocks (each of
256 threads a stride of blocks, then a tree).  The plain versions sum in
that order too, so that kernel and plain version agree bit for bit.

G2P writes the [16, NPAD] (3D) or [8, NPAD] (2D) rows kernel C takes:
velocity, then the moments S_ij = sum_k (w_k v_i) (x_k - p)_j centred on
the particle (kernel C's `centered` mode: grad = D^-1 S), zero on lanes
that take no part.  The rigid contact velocity of every lane
(rigid_velocity_sum) is kernel C's, from the new affinity word.
"""

from __future__ import annotations

import numpy as np
import torch

from wgsparkl_tpu_torch import _cuda
from wgsparkl_tpu_torch.collision.cdf import affinities_are_compatible
from wgsparkl_tpu_torch.math import div
from wgsparkl_tpu_torch.ops import rows as R
from wgsparkl_tpu_torch.ops.kernel import stencil_base_and_weights, stencil_offsets
from wgsparkl_tpu_torch.params import velocity_limit

DEFAULT_FRICTION = 20.0
NODE_BLOCK = 256      # nodes a block of the P2G kernel (impulse partials)
FINAL_THREADS = 256   # threads of the impulse reduction's last pass


def _adim(d: int) -> int:
    return 3 if d == 3 else 1


def project_velocity(vel, normal, friction: float = DEFAULT_FRICTION):
    """Friction-cone velocity projection (grid.wgsl:390-403); vel and
    normal: lists of d tensors."""
    d = len(vel)
    nvel = vel[0] * normal[0]
    for i in range(1, d):
        nvel = nvel + vel[i] * normal[i]
    tang = [vel[i] - normal[i] * nvel for i in range(d)]
    tl = tang[0] * tang[0]
    for i in range(1, d):
        tl = tl + tang[i] * tang[i]
    tl = torch.sqrt(tl)
    s = torch.clamp(tl + friction * nvel, min=0.0)
    big = tl > 1e-8
    tmax = torch.clamp(tl, min=1e-30)
    return [torch.where(nvel < 0.0,
                        torch.where(big, tang[i] / tmax, 0.0) * s, vel[i])
            for i in range(d)]


def velocity_at_point(btable, idx, point):
    """Velocity at world points (a list of d tensors) of the bodies idx
    (an int tensor of slots >= 0) from the body table: lin + ang x (p - com)
    (3D rows 0-2 COM, 3-5 linvel, 6-8 angvel; 2D rows 0-1, 2-3, 4)."""
    d = len(point)
    idx = idx.long()
    rel = [point[a] - btable[a][idx] for a in range(d)]
    lin = [btable[d + a][idx] for a in range(d)]
    if d == 2:
        om = btable[4][idx]
        return [lin[0] + om * -rel[1], lin[1] + om * rel[0]]
    a0, a1, a2 = (btable[6 + a][idx] for a in range(3))
    return [lin[0] + (a1 * rel[2] - a2 * rel[1]),
            lin[1] + (a2 * rel[0] - a0 * rel[2]),
            lin[2] + (a0 * rel[1] - a1 * rel[0])]


def _ghost(vel, bpv, nrm):
    proj = project_velocity([vel[i] - bpv[i] for i in range(len(vel))], nrm)
    return [bpv[i] + proj[i] for i in range(len(vel))]


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _lanes(rows, pcdf, n: int, live, d: int):
    """Per-lane inputs of the live lanes (lane < n and lane < live): lane
    ids [L] and position, velocity, mass, affine, affinity word, normal."""
    lane = torch.arange(n, device=rows.device)
    if live is not None:
        lane = lane[lane < int(live)]
    r = rows[:, lane]
    aff = R.aff_from_halves(pcdf[0, lane], pcdf[2 + d, lane])
    return (lane, [r[a] for a in range(d)], [r[d + a] for a in range(d)], r[2 * d],
            [[r[2 * d + 1 + d * i + j] for j in range(d)] for i in range(d)], aff,
            [pcdf[2 + a, lane] for a in range(d)])


def grid_update(grid_mm, params, grid):
    """Momentum -> velocity + gravity, clamped to one cell a substep
    (grid_update.wgsl:44-65), on grid rows [..., d + 1] (momentum, mass):
    the dense grid [M, d + 1] and the block grid alike.  The limit is
    f32(cell_width) / f32(dt), as the JAX package divides it."""
    d = grid.dim
    mass = grid_mm[..., d:]
    inv_mass = torch.where(mass > 0.0, 1.0 / torch.clamp(mass, min=1e-30), 0.0)
    vel = (grid_mm[..., :d] + mass * params.gravity * params.dt) * inv_mass
    lim = velocity_limit(grid.cell_width, params.dt)
    return torch.clamp(vel, -lim, lim)


def _tree(x, dim: int):
    """Pairwise sum over dim (a power of two) as a shared-memory tree sums:
    at stride s, entry t adds entry t + s."""
    s = x.shape[dim] // 2
    while s >= 1:
        x = x.narrow(dim, 0, s) + x.narrow(dim, s, s)
        s //= 2
    return x.squeeze(dim)


def reduce_impulses(node_imp, closest, nc: int):
    """[nc, C] per-body sums of the per-node impulses node_imp [M, C] over
    the nodes whose closest body it is: per 256-node block a tree, then
    over the blocks each of 256 lanes a stride of blocks in order, then a
    tree (the order of dense_p2g's two passes)."""
    m, c = node_imp.shape
    p = -(-m // NODE_BLOCK)
    pad = p * NODE_BLOCK - m
    imp = torch.nn.functional.pad(node_imp, (0, 0, 0, pad)).reshape(p, NODE_BLOCK, c)
    cl = torch.nn.functional.pad(closest, (0, pad), value=-1).reshape(p, NODE_BLOCK, 1)
    part = torch.stack([_tree(torch.where(cl == b, imp, 0.0), 1) for b in range(nc)],
                       1)                                               # [P, nc, C]
    p2 = -(-p // FINAL_THREADS) * FINAL_THREADS
    y = torch.nn.functional.pad(part, (0, 0, 0, 0, 0, p2 - p)).reshape(
        p2 // FINAL_THREADS, FINAL_THREADS, nc, c)
    acc = torch.zeros_like(y[0])
    for r in range(y.shape[0]):
        acc = acc + y[r]
    return _tree(acc, 0)


def _segment_sums(node, vals, m: int):
    """Per node, the sequential sum of vals [P, C] over its pairs in pair
    order (node [P] int64): [m, C]."""
    counts = torch.bincount(node, minlength=m)
    start = torch.cumsum(counts, 0) - counts
    acc = torch.zeros((m, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    for j in range(int(counts.max()) if node.numel() else 0):
        ok = counts > j
        idx = torch.clamp(start + j, max=max(vals.shape[0] - 1, 0))
        acc = acc + torch.where(ok[:, None], vals[idx], 0.0)
    return acc


def p2g_pairs(rows, pcdf, n: int, live, node_aff, node_closest, btable, grid,
              nc: int):
    """The (particle, stencil node) pairs of dense_p2g in its walk order (by
    node, then stencil offset, then lane): (node [P] int64, values [P, C]:
    momentum and mass of the compatible pairs, then the incompatible pairs'
    impulse, linear and angular, where the node has a closest body; zeros
    elsewhere)."""
    d = grid.dim
    lane, pos, vel, mass, aff_a, paff, nrm = _lanes(rows, pcdf, n, live, d)
    base, w, dpt = stencil_base_and_weights(torch.stack(pos, -1), grid.cell_width)
    nk = w.shape[1]
    cells = base[:, None, :] + torch.as_tensor(stencil_offsets(d), device=rows.device)
    valid = grid.in_bounds(cells).reshape(-1)
    node = grid.flatten_index(cells).reshape(-1).long()[valid]
    li = torch.arange(lane.shape[0], device=rows.device).repeat_interleave(nk)[valid]
    w = w.reshape(-1)[valid]
    dp = [dpt[..., a].reshape(-1)[valid] for a in range(d)]
    ps, vs, ms = [x[li] for x in pos], [x[li] for x in vel], mass[li]
    if nc > 0:
        use = affinities_are_compatible(node_aff[node], paff[li])
    else:
        use = torch.ones_like(w, dtype=torch.bool)
    cols = []
    for i in range(d):
        mp = aff_a[i][0][li] * dp[0]
        for j in range(1, d):
            mp = mp + aff_a[i][j][li] * dp[j]
        mp = mp + ms * vs[i]
        cols.append(torch.where(use, mp * w, 0.0))
    cols.append(torch.where(use, w * ms, 0.0))
    if nc > 0:
        cl = node_closest[node]
        imp = ~use & (cl >= 0)
        safe = torch.where(imp, cl, 0)
        cc = [dp[a] + ps[a] for a in range(d)]
        ghost = _ghost(vs, velocity_at_point(btable, safe, cc), [x[li] for x in nrm])
        wm = w * ms
        delta = [(vs[i] - ghost[i]) * wm for i in range(d)]
        lever = [btable[a][safe.long()] - cc[a] for a in range(d)]
        ang = (_cross(delta, lever) if d == 3
               else [delta[0] * lever[1] - delta[1] * lever[0]])
        cols += [torch.where(imp, x, 0.0) for x in delta + ang]
    order = torch.sort(node * nk + torch.arange(nk, device=rows.device).repeat(
        lane.shape[0])[valid], stable=True).indices
    return node[order], torch.stack(cols, -1)[order]


def p2g_plain(rows, pcdf, n: int, live, node_aff, node_closest, btable, grid,
              nc: int, nbodies: int):
    """Plain version of dense_p2g: (grid_mm [M, d + 1], lin [B, d], ang [B,
    a]), every sum in the kernel's order (see the module docstring)."""
    d = grid.dim
    node, vals = p2g_pairs(rows, pcdf, n, live, node_aff, node_closest, btable, grid,
                           nc)
    acc = _segment_sums(node, vals, grid.num_nodes)
    c = d + _adim(d)
    lin = torch.zeros((max(nbodies, 1), c), dtype=torch.float32, device=rows.device)
    if nc > 0:
        lin[:nc] = reduce_impulses(acc[:, d + 1:], node_closest, nc)
    return acc[:, :d + 1].contiguous(), lin[:, :d].contiguous(), lin[:, d:].contiguous()


def cell_lists(rows, n: int, live, grid):
    """The P2G kernel's glue: the lanes (below n and live) in a stable sort
    by stencil base cell on the grid grown by two cells below and above
    (every base cell whose stencil reaches a node), order int32 [NPAD],
    and each base cell's first position in that order, cell_start int32
    [M_ext + 1]; other lanes sort past the last cell."""
    d = grid.dim
    npad = rows.shape[1]
    ext = [s + 2 for s in grid.shape]
    lane = torch.arange(npad, device=rows.device)
    ok = lane < n
    if live is not None:
        ok = ok & (lane < live)
    key = None
    for a in range(d):
        e = (torch.round(div(rows[a], grid.cell_width)).to(torch.int32)
             - (int(grid.origin_cell[a]) - 1))
        ok = ok & (e >= 0) & (e < ext[a])
        key = e if key is None else key * ext[a] + e
    mext = int(np.prod(ext))
    key = torch.where(ok, key, mext).to(torch.int32)
    skey, order = torch.sort(key, stable=True)
    start = torch.searchsorted(
        skey, torch.arange(mext + 1, dtype=torch.int32, device=rows.device))
    return order.to(torch.int32), start.to(torch.int32)


def _geom(grid):
    d = grid.dim
    return (tuple(grid.shape) + (1,) * (3 - d), tuple(grid.origin_cell) + (0,) * (3 - d))


def _live_tensor(live, n: int, dev):
    if live is None:
        return torch.full((1,), n, dtype=torch.int32, device=dev)
    if live.dtype != torch.int32 or live.numel() != 1:
        raise TypeError("live must be a one-element int32 tensor")
    return live.reshape(1)


def dense_p2g(rows, pcdf, n: int, live, node_aff, node_closest, btable, grid,
              nc: int, nbodies: int):
    """P2G into the whole row-major grid: (grid_mm [M, d + 1] momentum and
    mass, lin_imp [B, d], ang_imp [B, 3 or 1]) of the lanes below n and
    live (None: all n), B = max(nbodies, 1).  node_aff / node_closest: the
    row-major node CDF (int32 [M]; unread at nc = 0).  One launch of kernel
    dense_p2g (its node pass and its impulse reduction) on the card, after
    the glue's lane sort; the plain version on the CPU."""
    if rows.device.type == "cpu":
        return p2g_plain(rows, pcdf, n, live, node_aff, node_closest, btable, grid,
                         nc, nbodies)
    d = grid.dim
    dev = rows.device
    m = grid.num_nodes
    c = d + _adim(d)
    if nc > 0 and (node_aff is None or node_aff.dtype != torch.int32
                   or node_closest.dtype != torch.int32 or node_aff.shape != (m,)
                   or node_closest.shape != (m,)):
        raise ValueError("dense_p2g: node_aff and node_closest int32 [M]")
    if nc > 16 or pcdf.shape != (8, rows.shape[1]):
        raise ValueError("dense_p2g: at most 16 colliders, pcdf [8, NPAD]")
    live_t = _live_tensor(live, n, dev)
    order, start = cell_lists(rows, n, live_t, grid)
    if nc == 0:
        node_aff = node_closest = start    # not read at nc = 0
    R.check_kernel_args(rows, pcdf, node_aff, node_closest, btable, order, start)
    grid_mm = torch.empty((m, d + 1), dtype=torch.float32, device=dev)
    nblk = -(-m // NODE_BLOCK)
    part = torch.empty((max(nblk * nc * c, 1),), dtype=torch.float32, device=dev)
    imp = torch.zeros((max(nbodies, 1), c), dtype=torch.float32, device=dev)
    shape, origin = _geom(grid)
    _cuda.launch("dense_p2g", f"dense_p2g{d}d_cuda", "pipppppp" + "i" * 7 + "fppp",
                 rows, rows.shape[1], pcdf, node_aff, node_closest, btable, order,
                 start, *shape, *origin, nc, R.f32(grid.cell_width), grid_mm, part, imp)
    dense_p2g.launches += 1
    return grid_mm, imp[:, :d].contiguous(), imp[:, d:].contiguous()


dense_p2g.launches = 0


def _krows_count(d: int) -> int:
    return 16 if d == 3 else 8


def g2p_plain(rows, pcdf, n: int, live, grid_vel, node_aff, node_closest, btable,
              grid, nc: int):
    """Plain version of dense_g2p: the G2P rows [16 or 8, NPAD]."""
    d = grid.dim
    lane, pos, vel, _, _, paff, nrm = _lanes(rows, pcdf, n, live, d)
    base, w, dpt = stencil_base_and_weights(torch.stack(pos, -1), grid.cell_width)
    offs = torch.as_tensor(stencil_offsets(d), device=rows.device)
    zero = torch.zeros_like(pos[0])
    v = [zero] * d
    s = [[zero] * d for _ in range(d)]
    for k in range(offs.shape[0]):
        cell = base + offs[k]
        valid = grid.in_bounds(cell)
        flat = torch.where(valid, grid.flatten_index(cell), 0).long()
        eff = [torch.where(valid, grid_vel[flat, i], 0.0) for i in range(d)]
        if nc > 0:
            na = torch.where(valid, node_aff[flat], 0)
            cl = torch.where(valid, node_closest[flat], -1)
            cc = [dpt[:, k, a] + pos[a] for a in range(d)]
            bpv = velocity_at_point(btable, torch.clamp(cl, min=0), cc)
            gh = _ghost(vel, bpv, nrm)
            comp = affinities_are_compatible(na, paff)
            eff = [torch.where(comp, eff[i], torch.where(cl >= 0, gh[i], vel[i]))
                   for i in range(d)]
        wk = torch.where(valid, w[:, k], 0.0)
        for i in range(d):
            we = wk * eff[i]
            v[i] = v[i] + we
            for j in range(d):
                s[i][j] = s[i][j] + we * dpt[:, k, j]
    out = torch.zeros((_krows_count(d), rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    out[:d, lane] = torch.stack(v)
    out[d:d + d * d, lane] = torch.stack([s[i][j] for i in range(d) for j in range(d)])
    return out


def dense_g2p(rows, pcdf, n: int, live, grid_vel, node_aff, node_closest, btable,
              grid, nc: int):
    """G2P from the row-major grid velocities grid_vel [M, d] with CPIC ghost
    velocities at incompatible nodes: the rows kernel C takes ([16, NPAD]
    in 3D, [8, NPAD] in 2D: velocity, then the centred moments; zero on the
    lanes >= n or >= live).  One launch of kernel dense_g2p on the card."""
    if rows.device.type == "cpu":
        return g2p_plain(rows, pcdf, n, live, grid_vel, node_aff, node_closest, btable,
                         grid, nc)
    d = grid.dim
    dev = rows.device
    if grid_vel.shape != (grid.num_nodes, d) or grid_vel.dtype != torch.float32:
        raise ValueError("dense_g2p: grid_vel f32 [M, d]")
    live_t = _live_tensor(live, n, dev)
    if nc == 0:
        node_aff = node_closest = live_t    # not read at nc = 0
    R.check_kernel_args(rows, pcdf, grid_vel, node_aff, node_closest, btable, live_t)
    out = torch.empty((_krows_count(d), rows.shape[1]), dtype=torch.float32, device=dev)
    shape, origin = _geom(grid)
    _cuda.launch("dense_g2p", f"dense_g2p{d}d_cuda", "piipppppp" + "i" * 7 + "fp",
                 rows, rows.shape[1], n, pcdf, grid_vel, node_aff, node_closest,
                 btable, live_t, *shape, *origin, nc, R.f32(grid.cell_width), out)
    dense_g2p.launches += 1
    return out


dense_g2p.launches = 0


def rigid_velocity_sum(pos, affinity, btable, num_colliders: int):
    """Sum of the velocity fields at pos [N, d] of the bodies the particle
    is affine to (g2p.wgsl:220-226).  On the step's path kernel C computes
    it from the new affinity word, on every lane."""
    d = pos.shape[1]
    p = [pos[:, a] for a in range(d)]
    out = [torch.zeros_like(p[0]) for _ in range(d)]
    for i in range(num_colliders):
        has = (affinity & (1 << i)) != 0
        bv = velocity_at_point(btable, torch.full_like(affinity, i), p)
        out = [out[a] + torch.where(has, bv[a], 0.0) for a in range(d)]
    return torch.stack(out, -1)
