"""Channel-major 2D particle rows and the window helpers of the 2D kernels
(port of wgsparkl_tpu/ops/pallas_transfer2d.py: the row layout and
pack_rows_padded / unpack_state_rows, :33-137, and the 2D body-table
helper _node_body_velocity, :236-248; the stencil and the ghost velocity
are ops/rows.py's, which take either dimension).

The whole per-particle state lives in one [PCHAN=32, NPAD] f32 matrix in
block-sorted order; rows 0..NCHAN-1 are what the transfer kernels read.
The CPIC affinity word rides as two <=16-bit integer-valued f32 halves: the
low half in row AFF, the high (sign) half in row AFF_SPARE.  Windows are the
10 x 10 nodes of an 8 x 8 block plus its high-side halo (WVOL = 100 nodes,
padded to WPAD = 104 rows), node index wx * 10 + wy.
"""

from __future__ import annotations

import dataclasses

import torch

from wgsparkl_tpu_torch.ops.rows import (
    MTAB_DP0, MTAB_LAM, MTAB_MU, MTAB_RAD, MTAB_STRETCH, MTAB_VOL,
    aff_from_halves, aff_halves, mtab_lookup,
)
from wgsparkl_tpu_torch.solver import DP_KEYS, DPS_KEYS

PX, PY, VX, VY, PM = 0, 1, 2, 3, 4
A0 = 5          # A00 A01 A10 A11 in rows 5..8
AFF = 9         # affinity low 16 bits
NX, NY = 10, 11
AFF_SPARE = 12  # affinity high (sign) 16 bits
R_IDS = 13
R_MID = 14
NCHAN = 16
R_DPS0 = 16
R_PHASE = 19
R_F0 = 20       # F00 F01 F10 F11
PERM_ROWS = 24
R_SD = 24
R_RV0 = 25
PCHAN = 32

WSH = (10, 10)
WVOL = 100
WPAD = 104
P2G_CHUNK = 256     # particles a chunk of kernel H (csrc/p2g2d.cu CHUNK2)


def pack_state_rows(particles, models):
    """Full 2D per-particle state -> [PCHAN, N] row matrix."""
    if models.mat_id is None:
        raise ValueError("row packing needs the material table "
                         "(solver.attach_material_table / MpmData)")
    n = particles.count
    z = torch.zeros(n, device=particles.pos.device)
    lo, hi = aff_halves(particles.cdf_affinity)
    a = particles.affine.reshape(n, 4)
    f = particles.def_grad.reshape(n, 4)
    cols = ([particles.pos[:, k] for k in range(2)]
            + [particles.vel[:, k] for k in range(2)] + [particles.mass]
            + [a[:, k] for k in range(4)]
            + [lo] + [particles.cdf_normal[:, k] for k in range(2)] + [hi]
            + [particles.ids.to(torch.float32), models.mat_id, z]
            + [models.dp_state[k] for k in DPS_KEYS] + [models.phase]
            + [f[:, k] for k in range(4)]
            + [particles.cdf_signed_distance]
            + [particles.cdf_rigid_vel[:, k] for k in range(2)])
    cols += [z] * (PCHAN - len(cols))
    return torch.stack(cols, dim=0)


def pack_rows_padded(particles, models, npad: int):
    """pack_state_rows lane-padded to npad; pad lanes get F = I."""
    n = particles.count
    rows = torch.nn.functional.pad(pack_state_rows(particles, models),
                                   (0, npad - n))
    for r in (R_F0, R_F0 + 3):
        rows[r, n:] = 1.0
    return rows


def unpack_state_rows(rows, particles, models, n_mat: int = 1):
    """[PCHAN, N] sorted rows -> (particles, models)."""
    n = particles.count
    mid = rows[R_MID]
    look = lambda r: mtab_lookup(models.mat_table, mid, r, n_mat)  # noqa: E731
    new_p = dataclasses.replace(
        particles,
        pos=rows[0:2].T.contiguous(), vel=rows[2:4].T.contiguous(),
        mass=rows[PM].clone(),
        affine=rows[A0:A0 + 4].T.reshape(n, 2, 2).contiguous(),
        cdf_affinity=aff_from_halves(rows[AFF], rows[AFF_SPARE]),
        def_grad=rows[R_F0:R_F0 + 4].T.reshape(n, 2, 2).contiguous(),
        init_volume=look(MTAB_VOL), init_radius=look(MTAB_RAD),
        ids=rows[R_IDS].to(torch.int32),
        cdf_normal=rows[NX:NX + 2].T.contiguous(),
        cdf_signed_distance=rows[R_SD].clone(),
        cdf_rigid_vel=rows[R_RV0:R_RV0 + 2].T.contiguous(),
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


# ------------------------------------------------ window helpers (plain path)
def node_body_velocity(closest, xw, btable, nc: int):
    """Velocity of each node's closest body from the 2D body table (rows
    0-1 COM, 2-3 linvel, 4 scalar angvel); zero where none.  closest
    [...], xw [..., 2]."""
    bv = [torch.zeros_like(closest) for _ in range(2)]
    for b in range(nc):
        mask = closest == b
        r = [xw[..., k] - btable[k, b] for k in range(2)]
        ang = btable[4, b]
        vb = [btable[2, b] - ang * r[1], btable[3, b] + ang * r[0]]
        bv = [torch.where(mask, vb[k], bv[k]) for k in range(2)]
    return bv
