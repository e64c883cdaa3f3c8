"""Channel-major particle rows and the job-window helpers shared by the
transfer kernels (port of wgsparkl_tpu/ops/pallas_transfer.py: the row
layout and pack_rows_padded / unpack_state_rows, :44-200, and the window
helpers, :202-570).

The whole per-particle state lives in one [PCHAN=48, NPAD] f32 matrix in
block-sorted order; rows 0..NCHAN-1 are what the transfer kernels read.
The CPIC affinity word rides as two <=16-bit integer-valued f32 halves
(rows AFF and AFF_SPARE); torch code carries the joined word as int32 and
masks after every right shift.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from wgsparkl_tpu_torch.collision import cdf_channel as cch
from wgsparkl_tpu_torch.solver import DP_KEYS, DPS_KEYS

PX, PY, PZ, VX, VY, VZ, PM = 0, 1, 2, 3, 4, 5, 6
A0 = 7          # A00..A22 in rows 7..15
AFF = 16        # affinity low 16 bits
NX, NY, NZ = 17, 18, 19
AFF_SPARE = 20  # affinity high (sign) 16 bits
R_IDS = 21
R_MID = 22
NCHAN = 24
R_DPS0 = 24
R_PHASE = 27
R_F0 = 28
PERM_ROWS = 40
R_SD = 40
R_RV0 = 41
PCHAN = 48

MTAB_LAM, MTAB_MU, MTAB_DP0 = 0, 1, 2
MTAB_STRETCH, MTAB_VOL, MTAB_RAD = 8, 9, 10

DEFAULT_FRICTION = 20.0
WV_MAX = 360    # largest window the CUDA kernels hold (by <= 8)


def window_geom(by: int = 4):
    """(wsh, wvol, wpad) of a 4 x by x 4 block's window (block + 2-node
    halo on the high side of each axis)."""
    wsh = (6, by + 2, 6)
    wvol = wsh[0] * wsh[1] * wsh[2]
    return wsh, wvol, -(-wvol // 8) * 8


def aff_halves(aff):
    """int32 affinity word -> (low, high) 16-bit halves as f32."""
    return ((aff & 0xFFFF).to(torch.float32),
            ((aff >> 16) & 0xFFFF).to(torch.float32))


def aff_from_halves(lo, hi):
    """(low, high) integer-valued f32 halves -> int32 affinity word."""
    v = lo.to(torch.int64) + hi.to(torch.int64) * 65536
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def pack_state_rows(particles, models):
    """Full per-particle state -> [PCHAN, N] row matrix."""
    if models.mat_id is None:
        raise ValueError("row packing needs the material table "
                         "(solver.attach_material_table / MpmData)")
    n = particles.count
    z = torch.zeros(n, device=particles.pos.device)
    lo, hi = aff_halves(particles.cdf_affinity)
    a = particles.affine.reshape(n, 9)
    f = particles.def_grad.reshape(n, 9)
    cols = ([particles.pos[:, k] for k in range(3)]
            + [particles.vel[:, k] for k in range(3)] + [particles.mass]
            + [a[:, k] for k in range(9)]
            + [lo] + [particles.cdf_normal[:, k] for k in range(3)] + [hi]
            + [particles.ids.to(torch.float32), models.mat_id, z]
            + [models.dp_state[k] for k in DPS_KEYS] + [models.phase]
            + [f[:, k] for k in range(9)] + [z, z, z]
            + [particles.cdf_signed_distance]
            + [particles.cdf_rigid_vel[:, k] for k in range(3)])
    cols += [z] * (PCHAN - len(cols))
    return torch.stack(cols, dim=0)


def pack_rows_padded(particles, models, npad: int):
    """pack_state_rows lane-padded to npad; pad lanes get F = I."""
    n = particles.count
    rows = torch.nn.functional.pad(pack_state_rows(particles, models),
                                   (0, npad - n))
    for r in (R_F0, R_F0 + 4, R_F0 + 8):
        rows[r, n:] = 1.0
    return rows


def mtab_lookup(table, mid, r: int, n_mat: int):
    """[N] constant of material-table row r by per-particle material id."""
    return table[r, :n_mat][mid.to(torch.int64).clamp(0, n_mat - 1)]


def unpack_state_rows(rows, particles, models, n_mat: int = 1):
    """[PCHAN, N] sorted rows -> (particles, models)."""
    n = particles.count
    mid = rows[R_MID]
    tab = models.mat_table
    look = lambda r: mtab_lookup(tab, mid, r, n_mat)  # noqa: E731
    new_p = dataclasses.replace(
        particles,
        pos=rows[0:3].T.contiguous(), vel=rows[3:6].T.contiguous(),
        mass=rows[PM].clone(),
        affine=rows[A0:A0 + 9].T.reshape(n, 3, 3).contiguous(),
        cdf_affinity=aff_from_halves(rows[AFF], rows[AFF_SPARE]),
        def_grad=rows[R_F0:R_F0 + 9].T.reshape(n, 3, 3).contiguous(),
        init_volume=look(MTAB_VOL), init_radius=look(MTAB_RAD),
        ids=rows[R_IDS].to(torch.int32),
        cdf_normal=rows[NX:NX + 3].T.contiguous(),
        cdf_signed_distance=rows[R_SD].clone(),
        cdf_rigid_vel=rows[R_RV0:R_RV0 + 3].T.contiguous(),
    )
    new_m = dataclasses.replace(
        models,
        lam=look(MTAB_LAM), mu=look(MTAB_MU),
        dp={k: look(MTAB_DP0 + i) for i, k in enumerate(DP_KEYS)},
        dp_state={k: rows[R_DPS0 + i].clone() for i, k in enumerate(DPS_KEYS)},
        phase=rows[R_PHASE].clone(), max_stretch=look(MTAB_STRETCH),
        mat_id=mid.clone(),
    )
    return new_p, new_m


def body_table(bodies):
    """The kernels' body table of a RigidWorld, lanes = slots: [32, 128] in
    3D (rows 0-2 world COM, 3-5 linvel, 6-8 angvel, 9-12 quaternion, 13-15
    translation, 16-23 shape params), [16, 128] in 2D (rows 0-1 world COM,
    2-3 linvel, 4 angvel, 5-6 rotation (cos, sin), 7-8 translation, 9-11
    shape params); the step's rows (gravity, velocity clamp:
    pipeline._body_table) zero."""
    nb, d = bodies.count, bodies.dim
    bt = torch.zeros((32 if d == 3 else 16, 128), dtype=torch.float32,
                     device=bodies.pos.device)
    a = bodies.angvel.shape[1]
    bt[0:d, :nb] = bodies.world_com.T
    bt[d:2 * d, :nb] = bodies.linvel.T
    bt[2 * d:2 * d + a, :nb] = bodies.angvel.T
    r0 = 2 * d + a
    bt[r0:r0 + bodies.rot.shape[1], :nb] = bodies.rot.T
    r0 += bodies.rot.shape[1]
    bt[r0:r0 + d, :nb] = bodies.pos.T
    bt[r0 + d:r0 + d + (8 if d == 3 else 3), :nb] = (
        bodies.shape_params[:, :8 if d == 3 else 3].T)
    return bt


def f32(x) -> float:
    """A Python float rounded to f32, as a kernel argument takes it."""
    return float(torch.tensor(x, dtype=torch.float32))


def nr_recip(x):
    """Newton-refined reciprocal, as the JAX kernels compute every in-kernel
    reciprocal of a physics quantity: r = 1/x, then r (2 - x r)."""
    r = 1.0 / x
    return r * (2.0 - x * r)


# ------------------------------------------------ window helpers (plain path)
def window_offsets(wsh, device):
    """[wvol, d] int64 node offsets of the window from the block origin
    (flat index wx * wsh[1] * wsh[2] + wy * wsh[2] + wz)."""
    g = np.stack(np.meshgrid(*[np.arange(s) for s in wsh], indexing="ij"), -1)
    return torch.as_tensor(g.reshape(-1, len(wsh)), device=device)


def window_positions(bcells, cell_width, wsh):
    """[J, wvol, 3] world positions of the job windows' nodes."""
    offs = window_offsets(wsh, bcells.device).to(torch.float32)
    return (offs[None] + bcells.to(torch.float32)[:, None, :]) * cell_width


def stencil(pos, bcell, inv_h, wsh):
    """Per-particle 3^d stencil inside its job window (d = len(pos)).

    pos: d channels [P]; bcell [P, d] int; wsh the window shape.  Returns
    (w [P, 3^d] weights in offset order, last axis fastest; nidx [P, 3^d]
    int64 row-major window node index; valid [P, 3^d]).  A stencil node
    outside the window (past its high edge when the base cell rounds up at
    an exact half-cell tie, below its low edge when p * (1/h) rounds below
    the p / h of the block sort key) is dropped, as the TPU kernels' window
    weight rows drop it: weight 0, index 0, valid False."""
    d = len(pos)
    ws, bls, oks = [], [], []
    for a in range(d):
        u = pos[a] * inv_h
        base = torch.floor(u + 0.5).to(torch.int32) - 1
        xf = u - base.to(torch.float32)
        t0, t1, t2 = 1.5 - xf, xf - 1.0, xf - 0.5
        ws.append((0.5 * (t0 * t0), 0.75 - t1 * t1, 0.5 * (t2 * t2)))
        bl = (base - bcell[:, a]).to(torch.int64)
        bls.append(bl)
        oks.append([(bl + o >= 0) & (bl + o < wsh[a]) for o in range(3)])
    w, nidx, valid = [], [], []
    for off in itertools.product(range(3), repeat=d):
        ok, wt, idx = oks[0][off[0]], ws[0][off[0]], bls[0] + off[0]
        for a in range(1, d):
            ok = ok & oks[a][off[a]]
            wt = wt * ws[a][off[a]]
            idx = idx * wsh[a] + bls[a] + off[a]
        valid.append(ok)
        w.append(torch.where(ok, wt, 0.0))
        nidx.append(torch.where(ok, idx, 0))
    return torch.stack(w, 1), torch.stack(nidx, 1), torch.stack(valid, 1)


LIST_CHUNK = 1024   # particles per list sort (csrc/transfer.cuh)


def lists_order(jid, lens, chunk: int = LIST_CHUNK):
    """Permutation of the row-major [P, 3^3] (particle, stencil offset) pairs
    of job_lanes' particles into the lists core's order of sums: chunks of
    `chunk` particles of each job, within a chunk the offsets in stencil
    order, within an offset the particles in order.  A node meets each
    offset once, so its pairs come offset by offset, each offset's bucket
    in particle order, as the kernels walk them."""
    lens = lens.to(torch.int64)
    k = torch.arange(jid.shape[0], device=jid.device)
    first = (torch.cumsum(lens, 0) - lens)[jid]
    chunk_first = k - (k - first) % chunk
    key = chunk_first[:, None] * 27 + torch.arange(27, device=jid.device)[None, :]
    return torch.sort(key.reshape(-1), stable=True).indices


def compat(naff, paff):
    """CPIC compatibility (grid.wgsl:250-255) of int32 affinity words."""
    common = naff & paff & 0xFFFF
    return (((naff >> 16) & 0xFFFF) & common) == (((paff >> 16) & 0xFFFF) & common)


def ghost_velocity(vp, bv, nrm, friction=DEFAULT_FRICTION):
    """CPIC ghost velocity of a particle velocity vp against body velocity
    bv with contact normal nrm (p2g.wgsl:200-231); lists of d tensors."""
    d = len(vp)
    u = [vp[i] - bv[i] for i in range(d)]
    nv = u[0] * nrm[0]
    for i in range(1, d):
        nv = nv + u[i] * nrm[i]
    tang = [u[i] - nrm[i] * nv for i in range(d)]
    tl = tang[0] * tang[0]
    for i in range(1, d):
        tl = tl + tang[i] * tang[i]
    tl = torch.sqrt(tl)
    inv_tl = torch.where(tl > 1e-8, nr_recip(torch.clamp(tl, min=1e-30)), 0.0)
    scale = torch.clamp(tl + friction * nv, min=0.0) * inv_tl
    sliding = nv < 0.0
    return [bv[i] + torch.where(sliding, tang[i] * scale, u[i]) for i in range(d)]


# Body-table rows of a collider's pose and shape, by dimension: (first
# rotation row, rotation rows, first translation row, first shape row).
# 3D: quaternion 9-12, translation 13-15, shape 16-23 (body_table);
# 2D: (cos, sin) 5-6, translation 7-8, shape 9-11.
_POSE_ROWS = {3: (9, 4, 13, 16), 2: (5, 2, 7, 9)}


def moving_node_cdf(xw, btable, desc, cell_width):
    """Analytic node CDF of the colliders of desc ((slot, shape), ...,
    evaluated in that order) at window nodes xw [..., d] from the body
    table of dimension d (_POSE_ROWS; in 2D the port of
    `_moving_node_cdf_2d`).  Returns (dist, aff int32, closest f32): BIG, 0
    and -1 where none."""
    d = xw.shape[-1]
    r0, nr, t0, p0 = _POSE_ROWS[d]
    pos = [xw[..., a] for a in range(d)]
    dist = torch.full_like(pos[0], cch.BIG)
    aff = torch.zeros(pos[0].shape, dtype=torch.int32, device=xw.device)
    closest = torch.full_like(pos[0], -1.0)
    for slot, st in desc:
        rot = [btable[r0 + k, slot] for k in range(nr)]
        trans = [btable[t0 + k, slot] for k in range(d)]
        par = [btable[p0 + k, slot] for k in range(3)]
        within, inside, di = cch.collider_cdf(st, rot, trans, par, pos,
                                              1.5 * cell_width)
        closer = within & (di < dist)
        closest = torch.where(closer, float(slot), closest)
        dist = torch.where(closer, di, dist)
        bits = torch.where(inside, cch.bit(16 + slot) | cch.bit(slot),
                           cch.bit(slot))
        aff = aff | torch.where(within, bits, 0).to(torch.int32)
    return dist, aff, closest


def window_cdf(ntiles, xw, btable, moving, lvl, cell_width, wvol,
               static_desc=(), chan_free=False):
    """Per-job window node CDF (naff int32, closest f32, ndist f32), each
    [J, wvol], at gate levels lvl [J].  Gathered: the static channels of
    ntiles, merged at level >= 2 with the in-kernel moving colliders
    (strictly smaller distance wins, the lower collider index on exact
    ties, affinity words OR).  chan_free: no tile is read; level 1
    evaluates the static colliders, level >= 2 all colliders in index
    order."""
    lv2 = (lvl >= 2)[:, None]
    if chan_free:
        s_dist, s_aff, s_closest = moving_node_cdf(xw, btable, static_desc,
                                                   cell_width)
        if not moving:
            return s_aff, s_closest, s_dist
        a_dist, a_aff, a_closest = moving_node_cdf(
            xw, btable, tuple(sorted(static_desc + moving)), cell_width)
        return (torch.where(lv2, a_aff, s_aff), torch.where(lv2, a_closest, s_closest),
                torch.where(lv2, a_dist, s_dist))
    t = ntiles[:, :wvol]
    naff = aff_from_halves(t[..., 0], t[..., 1])
    s_closest, s_dist = t[..., 2], t[..., 3]
    if not moving:
        return naff, s_closest, s_dist
    d_dist, d_aff, d_closest = moving_node_cdf(xw, btable, moving, cell_width)
    da = torch.where(s_closest >= 0.0, s_dist, cch.BIG)
    b_wins = (d_closest >= 0.0) & (
        (d_dist < da)
        | ((d_dist == da) & ((s_closest < 0.0) | (d_closest < s_closest))))
    return (torch.where(lv2, naff | d_aff, naff),
            torch.where(lv2, torch.where(b_wins, d_closest, s_closest), s_closest),
            torch.where(lv2, torch.where(b_wins, d_dist, da), s_dist))


def fold_velocity(ftiles, btable, d: int, row: int):
    """The grid update that G2P does in-kernel under `fold_vel`, on window
    tiles [..., 4] of raw momentum (cols 0..d-1) and mass (col d): v =
    clip((mom + m g dt) * nr_recip(max(m, 1e-30)), -vlim, vlim), zero where
    m = 0, with g dt in lanes 0..d-1 of body-table row `row` and vlim in
    lane d (the kernels' order of operations, not _grid_velocity's).
    Returns the tiles with the velocity in place of the momentum."""
    m = ftiles[..., d]
    inv_m = torch.where(m > 0.0, nr_recip(torch.clamp(m, min=1e-30)), 0.0)
    vlim = btable[row, d]
    v = [torch.clamp((ftiles[..., k] + m * btable[row, k]) * inv_m, -vlim, vlim)
         for k in range(d)]
    return torch.cat([torch.stack(v, -1), ftiles[..., d:]], -1)


def node_body_velocity(closest, xw, btable, nc: int):
    """Velocity of each node's closest body (rows 0-2 COM, 3-5 linvel,
    6-8 angvel); zero where none.  closest [...], xw [..., 3]."""
    bv = [torch.zeros_like(closest) for _ in range(3)]
    for b in range(nc):
        mask = closest == b
        com = [btable[k, b] for k in range(3)]
        lin = [btable[3 + k, b] for k in range(3)]
        ang = [btable[6 + k, b] for k in range(3)]
        r = [xw[..., k] - com[k] for k in range(3)]
        vb = [lin[0] + ang[1] * r[2] - ang[2] * r[1],
              lin[1] + ang[2] * r[0] - ang[0] * r[2],
              lin[2] + ang[0] * r[1] - ang[1] * r[0]]
        bv = [torch.where(mask, vb[k], bv[k]) for k in range(3)]
    return bv


def job_lanes(jobs):
    """(jid [P], lane [P]) of every particle covered by a live job:
    job j owns sorted ranks [start_j, start_j + len_j)."""
    lens = jobs["len"].to(torch.int64)
    jid = torch.repeat_interleave(torch.arange(lens.shape[0], device=lens.device),
                                  lens)
    first = torch.cumsum(lens, 0) - lens
    k = torch.arange(jid.shape[0], device=lens.device)
    return jid, jobs["start"].to(torch.int64)[jid] + k - first[jid]


def check_kernel_args(*tensors):
    """The CUDA kernels take contiguous tensors on one card."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("kernel arguments must be contiguous tensors on "
                             f"one device (got {t.device}, contiguous="
                             f"{t.is_contiguous()})")
