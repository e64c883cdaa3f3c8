"""Fused particle update and row rebuild (port of
wgsparkl_tpu/ops/update_rows.py, `update_rows` with dim=3 and dim=2;
kernel C, csrc/update_rows.cu, one entry point per dimension).

From the sorted rows, the G2P rows, the particle-CDF rows and the sorted
block ids it computes the next substep's [PCHAN, NPAD] row matrix: the rigid
contact velocity from the body table, the material constants by id (from
the [16, M] material table: M = 128 on the pallas path, a multiple of 128
on the dense and blocked transfers), and particle_update_channels with
the corotated or the neo-Hookean stress (`elastic_model`; the kernel takes
its index in ELASTIC_MODELS).  Lanes
are live iff id < live_below and rank < covered_end; dead lanes keep their
position and get zero velocity inputs.  The G2P rows hold the velocity and
the moments sum_k w_k v_i x_k, from which the gradient is D^-1 (S - v p^T);
with `centered` (the dense transfer's G2P) the moments are already centred
on the particle, sum_k w_k v_i (x_k - p), and the gradient is D^-1 S.
With `rv_rows` (the struct-form particle update, ops/particle_update.py)
the rigid contact velocity is read from the rows' own rigid-velocity rows
instead of being summed from the body table.
`update_rows` is the 3D branch, `update_rows2d` the 2D one (rows of
ops/rows2d.py); each counts its own launches.
"""

from __future__ import annotations

import torch

from wgsparkl_tpu_torch import _cuda
from wgsparkl_tpu_torch.ops import rows as R
from wgsparkl_tpu_torch.ops import rows2d as R2
from wgsparkl_tpu_torch.ops.kernel import inv_d
from wgsparkl_tpu_torch.ops.particle_update import (
    ELASTIC_MODELS, particle_update_channels,
)
from wgsparkl_tpu_torch.params import velocity_limit
from wgsparkl_tpu_torch.solver import DP_KEYS, DPS_KEYS


def _rigid_velocity(pos, aff, btable, nc: int):
    """Rigid contact velocity: the sum of the velocities at pos of the
    bodies in the particle's affinity word (3D body table rows 0-2 COM,
    3-5 linvel, 6-8 angvel; 2D rows 0-1 COM, 2-3 linvel, 4 angvel)."""
    d = len(pos)
    rv = [torch.zeros_like(pos[0])] * d
    for b in range(nc):
        has = ((aff >> b) & 1) != 0
        rel = [pos[k] - btable[k, b] for k in range(d)]
        lin = [btable[d + k, b] for k in range(d)]
        if d == 3:
            ang = [btable[6 + k, b] for k in range(3)]
            bvb = [lin[0] + ang[1] * rel[2] - ang[2] * rel[1],
                   lin[1] + ang[2] * rel[0] - ang[0] * rel[2],
                   lin[2] + ang[0] * rel[1] - ang[1] * rel[0]]
        else:
            ang = btable[4, b]
            bvb = [lin[0] - ang * rel[1], lin[1] + ang * rel[0]]
        rv = [rv[k] + torch.where(has, bvb[k], 0.0) for k in range(d)]
    return rv


def _update_plain(L, d, rows_all, krows, pcdf, sorted_ids, covered_end, btable,
                  mtable, dt, h, nc, n_mat, live_below, elastic_model, centered,
                  rv_rows):
    npad = rows_all.shape[1]
    lane = torch.arange(npad, device=rows_all.device)
    ig = (sorted_ids < live_below) & (lane < covered_end)
    row = lambda ref, i: ref[i, :npad]  # noqa: E731
    pos = [row(rows_all, k) for k in range(d)]
    v = [torch.where(ig, row(krows, k), 0.0) for k in range(d)]
    inv = inv_d(h)
    grad = {(i, k): torch.where(ig, inv * (row(krows, d + d * i + k)
                                           - (0.0 if centered else v[i] * pos[k])),
                                0.0)
            for i in range(d) for k in range(d)}
    f = {(i, k): row(rows_all, L.R_F0 + d * i + k)
         for i in range(d) for k in range(d)}
    aff_lo = torch.where(ig, row(pcdf, 0), 0.0)
    aff_hi = torch.where(ig, row(pcdf, 2 + d), 0.0)
    sd = torch.where(ig, row(pcdf, 1), 0.0)
    nrm = [torch.where(ig, row(pcdf, 2 + k), 0.0) for k in range(d)]
    rv = ([row(rows_all, L.R_RV0 + k) for k in range(d)] if rv_rows
          else _rigid_velocity(pos, R.aff_from_halves(aff_lo, aff_hi), btable, nc))
    mid = row(rows_all, L.R_MID)
    mval = lambda r: R.mtab_lookup(mtable, mid, r, n_mat)  # noqa: E731
    ch = {
        "pos": pos, "vel": v, "grad": grad, "F": f, "sd": sd, "normal": nrm,
        "rigid_vel": rv, "mass": row(rows_all, L.PM), "vol0": mval(R.MTAB_VOL),
        "lam": mval(R.MTAB_LAM), "mu": mval(R.MTAB_MU),
        "dp": {k: mval(R.MTAB_DP0 + i) for i, k in enumerate(DP_KEYS)},
        "dps": {k: row(rows_all, L.R_DPS0 + i) for i, k in enumerate(DPS_KEYS)},
        "phase": row(rows_all, L.R_PHASE), "stretch": mval(R.MTAB_STRETCH),
    }
    out = particle_update_channels(ch, dt, h, elastic_model)
    new_rows = (
        out["pos"] + out["vel"] + [row(rows_all, L.PM)]
        + [out["affine"][(i, k)] for i in range(d) for k in range(d)]
        + [aff_lo] + nrm + [aff_hi]
        + [row(rows_all, r) for r in range(L.NCHAN - 3, L.NCHAN)]
        + [out["dps"][k] for k in DPS_KEYS] + [out["phase"]]
        + [out["F"][(i, k)] for i in range(d) for k in range(d)]
        + [row(rows_all, r) for r in range(L.R_F0 + d * d, L.PERM_ROWS)]
        + [sd] + rv
        + [row(rows_all, r) for r in range(L.R_RV0 + d, L.PCHAN)]
    )
    return torch.stack(new_rows, dim=0)


def update_plain(rows_all, krows, pcdf, sorted_ids, covered_end, btable,
                 mtable, dt: float, h: float, nc: int, n_mat: int,
                 live_below: int, elastic_model: str = "corotated",
                 centered: bool = False, rv_rows: bool = False):
    return _update_plain(R, 3, rows_all, krows, pcdf, sorted_ids, covered_end,
                         btable, mtable, dt, h, nc, n_mat, live_below,
                         elastic_model, centered, rv_rows)


def update2d_plain(rows_all, krows, pcdf, sorted_ids, covered_end, btable,
                   mtable, dt: float, h: float, nc: int, n_mat: int,
                   live_below: int, elastic_model: str = "corotated",
                   centered: bool = False, rv_rows: bool = False):
    return _update_plain(R2, 2, rows_all, krows, pcdf, sorted_ids, covered_end,
                         btable, mtable, dt, h, nc, n_mat, live_below,
                         elastic_model, centered, rv_rows)


def kernel_scalars(dt: float, h: float):
    """Kernel C's f32 scalars: dt, h, the APIC D^-1 scale, the velocity
    limit h / dt (divided in f32, as the JAX package divides it) and the
    penetration depths -0.05 h and -0.3 h."""
    return (R.f32(dt), R.f32(h), R.f32(inv_d(h)), velocity_limit(h, dt),
            R.f32(-0.05 * h), R.f32(-0.3 * h))


def _launch(symbol, pchan, nkrows, rows_all, krows, pcdf, sorted_ids,
            covered_end, btable, mtable, dt, h, nc, n_mat, live_below,
            elastic_model, centered, rv_rows):
    """Check the arguments of one dimension's entry and launch it."""
    npad = rows_all.shape[1]
    if (rows_all.shape[0] != pchan or krows.shape[0] != nkrows
            or pcdf.shape[0] != 8):
        raise ValueError(f"{symbol} takes [{pchan}, NPAD] rows, [{nkrows}, .] "
                         "G2P rows and [8, .] particle-CDF rows")
    if krows.shape[1] < npad or pcdf.shape[1] < npad:
        raise ValueError("G2P / particle-CDF rows narrower than NPAD")
    if sorted_ids.dtype != torch.int32 or sorted_ids.shape != (npad,):
        raise TypeError("sorted_ids must be int32 [NPAD]")
    if mtable.dim() != 2 or mtable.shape[0] != 16:
        raise ValueError("the material table is [16, M]")
    if not 0 <= nc <= 16 or not 1 <= n_mat <= mtable.shape[1]:
        raise ValueError("at most 16 colliders, and 1 to M materials in a "
                         f"[16, {mtable.shape[1]}] material table")
    ce = torch.as_tensor(covered_end, dtype=torch.int32,
                         device=rows_all.device).reshape(1)
    R.check_kernel_args(rows_all, krows, pcdf, sorted_ids, ce, btable, mtable)
    out = torch.empty_like(rows_all)
    _cuda.launch(
        "update_rows", symbol, "pppppppiiiiiiiiiiffffffp",
        rows_all, krows, pcdf, sorted_ids, ce, btable, mtable,
        npad, krows.shape[1], pcdf.shape[1], mtable.shape[1], nc, n_mat, live_below,
        ELASTIC_MODELS.index(elastic_model), int(centered), int(rv_rows),
        *kernel_scalars(dt, h),
        out)
    return out


def update_rows(rows_all, krows, pcdf, sorted_ids, covered_end, btable,
                mtable, dt: float, h: float, nc: int, n_mat: int,
                live_below: int, elastic_model: str = "corotated",
                centered: bool = False, rv_rows: bool = False):
    """Next-substep rows [PCHAN, NPAD] (see the module docstring).
    krows [16, >=NPAD] and pcdf [8, >=NPAD] are read on their first NPAD
    lanes; covered_end is a 0-d int tensor or an int."""
    args = (rows_all, krows, pcdf, sorted_ids, covered_end, btable, mtable,
            dt, h, nc, n_mat, live_below, elastic_model, centered, rv_rows)
    if rows_all.device.type == "cpu":
        return update_plain(*args)
    out = _launch("update_rows_cuda", R.PCHAN, 16, *args)
    update_rows.launches += 1
    return out


update_rows.launches = 0


def update_rows2d(rows_all, krows, pcdf, sorted_ids, covered_end, btable,
                  mtable, dt: float, h: float, nc: int, n_mat: int,
                  live_below: int, elastic_model: str = "corotated",
                  centered: bool = False, rv_rows: bool = False):
    """The dim=2 branch: next-substep 2D rows [32, NPAD] from the rows, the
    2D G2P rows [8, >=NPAD] (velocity, moments), the 2D particle-CDF rows
    [8, >=NPAD] (aff low, sd, normal, aff high) and the 2D body table."""
    args = (rows_all, krows, pcdf, sorted_ids, covered_end, btable, mtable,
            dt, h, nc, n_mat, live_below, elastic_model, centered, rv_rows)
    if rows_all.device.type == "cpu":
        return update2d_plain(*args)
    out = _launch("update_rows2d_cuda", R2.PCHAN, 8, *args)
    update_rows2d.launches += 1
    return out


update_rows2d.launches = 0
