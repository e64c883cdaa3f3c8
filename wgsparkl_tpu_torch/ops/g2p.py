"""G2P with CPIC ghost velocities (port of
wgsparkl_tpu/ops/pallas_transfer.py, `g2p_rows` and its body
`_g2p_kernel`; kernel B, csrc/g2p.cu).

Per particle, over its 3^3 stencil in the job's window: the PIC velocity
(rows 0-2) and the velocity moment sum w v x^T (rows 3-11, row 3 + 3 i + k
= sum w v_i x_k) of [16, NPAD + G + 128].  At gate level >= 1 the weights
are masked by CPIC compatibility; an incompatible node contributes the
particle's ghost velocity instead: at level 1 (static colliders, body
velocity zero) the per-particle static ghost chain, at level 2 the
pairwise ghost against the node's closest body, the particle's own
velocity where the node has no body.  The window node CDF is the one
kernel A reads (ops/p2g_cdf.py: gathered channels merged with the moving
colliders, or in chan-free mode every collider evaluated in-kernel).
With `fold_vel` the grid tiles hold raw momentum and mass, and the grid
update (rows.fold_velocity) is done on each window node as its tile is
read.  Each job writes its own lanes [start, start + len).
"""

from __future__ import annotations

import torch

from wgsparkl_tpu_torch import _cuda
from wgsparkl_tpu_torch.ops import rows as R
from wgsparkl_tpu_torch.ops.p2g_cdf import (
    _seqsum, check_node_tiles, collider_words, job_table,
)


def ghost_static(vp, nrm, friction=R.DEFAULT_FRICTION):
    """Ghost velocity against a body at rest: per particle, no node data."""
    nv = vp[0] * nrm[0] + vp[1] * nrm[1] + vp[2] * nrm[2]
    tang = [vp[i] - nrm[i] * nv for i in range(3)]
    tl = torch.sqrt(tang[0] * tang[0] + tang[1] * tang[1] + tang[2] * tang[2])
    inv_tl = torch.where(tl > 1e-8, R.nr_recip(torch.clamp(tl, min=1e-30)), 0.0)
    scale = torch.clamp(tl + friction * nv, min=0.0) * inv_tl
    return [torch.where(nv < 0.0, tang[i] * scale, vp[i]) for i in range(3)]


def g2p_plain(pdata, ftiles, ntiles, btable, jobs, bcells, jbody, cell_width,
              by, group, npad, nc, moving=(), static_desc=(), chan_free=False,
              fold_vel=False):
    dev = pdata.device
    if fold_vel:
        ftiles = R.fold_velocity(ftiles, btable, 3, 24)
    wsh, wvol, _ = R.window_geom(by)
    jid, lane = R.job_lanes(jobs)
    lvl = jbody.to(torch.int64)[jid]
    xw = R.window_positions(bcells, cell_width, wsh)
    pd = pdata[:R.NCHAN, lane]
    bc = bcells.to(torch.int64)[jid]
    inv_h = float(torch.tensor(1.0 / cell_width, dtype=torch.float32))
    w, nidx, _ = R.stencil([pd[0], pd[1], pd[2]], bc, inv_h, wsh)
    fi = jid[:, None] * wvol + nidx
    v = [ftiles[:, :wvol, k].reshape(-1)[fi] for k in range(3)]
    x = [xw[..., k].reshape(-1)[fi] for k in range(3)]
    vp = [pd[R.VX + k] for k in range(3)]
    nrm = [pd[R.NX + k] for k in range(3)]
    rows = [None] * 12
    if nc > 0:
        naff_w, closest_w, _ = R.window_cdf(ntiles, xw, btable, moving, jbody,
                                            cell_width, wvol, static_desc,
                                            chan_free)
        naff = naff_w.reshape(-1)[fi]
        closest = closest_w.reshape(-1)[fi]
        paff = R.aff_from_halves(pd[R.AFF], pd[R.AFF_SPARE])
        gated = (lvl > 0)[:, None]
        wc = torch.where(gated & ~R.compat(naff, paff[:, None]), 0.0, w)
    else:
        wc = w
    for i in range(3):
        rows[i] = _seqsum(wc * v[i])
        for k in range(3):
            rows[3 + 3 * i + k] = _seqsum(wc * (v[i] * x[k]))
    if nc > 0:
        wi = w - wc
        hb = (closest >= 0).to(torch.float32)
        # Level 1: ghost against bodies at rest, one chain per particle.
        wib = wi * hb
        win = wi - wib
        dib = [_seqsum(wib)] + [_seqsum(x[k] * wib) for k in range(3)]
        din = [_seqsum(win)] + [_seqsum(x[k] * win) for k in range(3)]
        rel = ghost_static(vp, nrm)
        ex1 = [[dib[m] * rel[i] + din[m] * vp[i] for m in range(4)]
               for i in range(3)]
        # Level 2: pairwise ghost against each node's closest body.
        bv_w = R.node_body_velocity(closest_w, xw, btable, nc)
        bv = [b.reshape(-1)[fi] for b in bv_w]
        gb = R.ghost_velocity([u[:, None] for u in vp], bv,
                              [n[:, None] for n in nrm])
        g = [torch.where(closest >= 0, gb[i], vp[i][:, None]) for i in range(3)]
        ex2 = []
        for i in range(3):
            wg = wi * g[i]
            ex2.append([_seqsum(wg)] + [_seqsum(x[k] * wg) for k in range(3)])
        for i in range(3):
            for m in range(4):
                r = i if m == 0 else 3 + 3 * i + (m - 1)
                extra = torch.where(lvl == 1, ex1[i][m],
                                    torch.where(lvl >= 2, ex2[i][m], 0.0))
                rows[r] = torch.where(lvl > 0, rows[r] + extra, rows[r])
    out = torch.zeros((16, npad + group + 128), dtype=torch.float32, device=dev)
    out[:12, lane] = torch.stack(rows, 0)
    return out


def g2p_rows(pdata, ftiles, ntiles, btable, jobs, bcells, jbody,
             cell_width: float, by: int, group: int, npad: int, nc: int,
             moving=(), static_desc=(), chan_free: bool = False,
             fold_vel: bool = False):
    """Per-particle G2P rows [16, NPAD + G + 128] (see the module
    docstring).  pdata: rows with the fresh particle CDF patched in (rows
    0..23 are read); ftiles [MAXJ, wpad, 4] gathered grid velocity + mass
    (raw momentum + mass with fold_vel); ntiles, moving, static_desc and
    chan_free as for p2g_cdf_tiles (ntiles is not read at nc = 0 either)."""
    if pdata.device.type == "cpu":
        return g2p_plain(pdata, ftiles, ntiles, btable, jobs, bcells, jbody,
                         cell_width, by, group, npad, nc, moving, static_desc,
                         chan_free, fold_vel)
    wsh, wvol, wpad = R.window_geom(by)
    maxj = jobs["start"].shape[0]
    if (wvol > R.WV_MAX or nc > 16 or ftiles.shape != (maxj, wpad, 4)
            or ntiles.shape[1:] != (wpad, 4)):
        raise ValueError("g2p_rows: by <= 8, <= 16 colliders and "
                         "[MAXJ, wpad, 4] tiles")
    if nc > 0:
        check_node_tiles("g2p_rows", ntiles, maxj, wpad, chan_free)
    jt = job_table(jobs, bcells, jbody)
    R.check_kernel_args(pdata, ftiles, ntiles, btable, jt)
    out = torch.zeros((16, npad + group + 128), dtype=torch.float32,
                      device=pdata.device)
    _cuda.launch("g2p", "g2p_cuda", "pippppiiiiiiiifffpi",
                 pdata, pdata.shape[1], ftiles, ntiles, btable, jt, maxj, by,
                 nc, *collider_words(moving, static_desc), int(chan_free),
                 int(fold_vel), R.f32(cell_width), R.f32(1.0 / cell_width),
                 R.f32(1.5 * cell_width), out, out.shape[1])
    g2p_rows.launches += 1
    return out


g2p_rows.launches = 0
