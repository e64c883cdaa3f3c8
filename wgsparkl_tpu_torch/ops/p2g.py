"""APIC P2G without the particle CDF (port of
wgsparkl_tpu/ops/pallas_transfer.py, `p2g_tiles` and its body `_p2g_kernel`
with `_window_w`, `_p2g_feats32` / `_mm_from_feats32`, `_compat`,
`_node_body_velocity` and `_ghost_velocity`; kernel F, csrc/p2g.cu).

Per job (up to `group` sorted particles of one 4 x by x 4 block) every
particle adds, at each node of its 3^3 stencil inside the job's window,
w times its 13 features (m v - A x_p, m, A; p2g_cdf.p2g_features) to the
node's sums, which the tile recombines with the node position x_node into
momentum sum w (m v - A x_p) + (sum w A) x_node and mass sum w m (A: the
particle's affine rows A0..A0+8 as stored), into the job's window tile
[wpad, 8] (cols 0-2 momentum, 3 mass, 4-7 zero).  This is kernel A's P2G
form, the TPU kernel's too; each node sums its pairs in the lists order of
csrc/transfer.cuh (rows.lists_order: per chunk of up to 1024 particles of a
job, stencil offsets in order, each offset's particles in particle order),
where the TPU kernel contracts a dense window x group matrix product: a
tolerance against it, and bit-equality between the plain version and the
CUDA kernel.

With colliders (nc > 0) a job whose gate level jbody is > 0 masks W by CPIC
compatibility between the window node's affinity word (the job's node
tiles) and the particle's stored one (rows AFF / AFF_SPARE), and reduces
the impulses of its incompatible (node, particle) pairs against the node's
closest body per collider: per node in the lists order, per job over window
nodes in node order, over jobs in job order (imp [1, 8, 128], rows 0-2
linear and 3-5 angular impulse, lanes = collider slots).  No pipeline path
takes that branch; the collider-free substep (nc = 0) takes the other.
"""

from __future__ import annotations

import torch

from wgsparkl_tpu_torch import _cuda
from wgsparkl_tpu_torch.ops import rows as R
from wgsparkl_tpu_torch.ops.blocked import add_rows
from wgsparkl_tpu_torch.ops.p2g_cdf import _seqsum, job_table, p2g_node_tiles


def p2g_plain(pdata, ntiles, btable, jobs, bcells, jbody, cell_width, by, nc):
    dev = pdata.device
    wsh, wvol, wpad = R.window_geom(by)
    maxj = jobs["start"].shape[0]
    jid, lane = R.job_lanes(jobs)
    pd = pdata[:R.NCHAN, lane]
    bc = bcells.to(torch.int64)[jid]
    w, nidx, _ = R.stencil([pd[0], pd[1], pd[2]], bc, R.f32(1.0 / cell_width), wsh)
    fi = jid[:, None] * wvol + nidx
    xw = R.window_positions(bcells, cell_width, wsh)                # [J, wvol, 3]
    gated = (jbody.to(torch.int64)[jid] > 0)[:, None] & (nc > 0)
    if nc > 0:
        t = ntiles[:, :wvol]
        closest_w = t[..., 2]
        naff = R.aff_from_halves(t[..., 0], t[..., 1]).reshape(-1)[fi]
        comp = R.compat(naff, R.aff_from_halves(pd[R.AFF], pd[R.AFF_SPARE])[:, None])
        wc = torch.where(gated & ~comp, 0.0, w)
    else:
        wc = w
    # Each node's pairs are added in the kernel's lists order.
    order = R.lists_order(jid, jobs["len"])
    mm = p2g_node_tiles(pd, wc, fi, xw, wpad, order)

    imp = torch.zeros((1, 8, 128), dtype=torch.float32, device=dev)
    if nc == 0:
        return mm, imp
    # Impulses of the incompatible pairs against each node's closest body.
    closest = closest_w.reshape(-1)[fi]
    bvp = [b.reshape(-1)[fi] for b in R.node_body_velocity(closest_w, xw, btable, nc)]
    vp = [pd[R.VX + k][:, None] for k in range(3)]
    ghost = R.ghost_velocity(vp, bvp, [pd[R.NX + k][:, None] for k in range(3)])
    w_i = torch.where(comp | (closest < 0.0) | ~gated, 0.0, w) * pd[R.PM][:, None]
    d = torch.stack([w_i * (vp[k] - ghost[k]) for k in range(3)], -1).reshape(-1, 3)
    dsum = torch.zeros((maxj * wvol, 3), dtype=torch.float32, device=dev)
    add_rows(dsum, fi.reshape(-1)[order], d[order])
    d, x = dsum.reshape(maxj, wvol, 3), xw
    vals = torch.stack([d[..., 0], d[..., 1], d[..., 2],       # d, d x x_node
                        d[..., 1] * x[..., 2] - d[..., 2] * x[..., 1],
                        d[..., 2] * x[..., 0] - d[..., 0] * x[..., 2],
                        d[..., 0] * x[..., 1] - d[..., 1] * x[..., 0]], -1)
    mask = torch.stack([closest_w == b for b in range(nc)], -1).to(torch.float32)
    # [MAXJ, 6, nc]: window nodes summed in node order.
    s = _seqsum((vals[..., None] * mask[:, :, None, :]).permute(0, 2, 3, 1))
    com = btable[0:3, :nc]
    db, cb = s[:, 0:3], s[:, 3:6]
    part = torch.cat([db, db[:, [1]] * com[2] - db[:, [2]] * com[1] - cb[:, [0]],
                      db[:, [2]] * com[0] - db[:, [0]] * com[2] - cb[:, [1]],
                      db[:, [0]] * com[1] - db[:, [1]] * com[0] - cb[:, [2]]], 1)
    imp[0, 0:6, :nc] = _seqsum(part.permute(1, 2, 0))     # jobs in job order
    return mm, imp


def p2g_tiles(pdata, ntiles, btable, jobs, bcells, jbody, cell_width: float,
              by: int, nc: int):
    """(mm [MAXJ, wpad, 8], imp [1, 8, 128]); see the module docstring.
    pdata: the sorted rows (rows 0..23 are read); btable the [32, 128] body
    table; jbody [MAXJ] int gate levels.  With nc = 0 neither the node
    tiles nor the gate levels are read: the collider-free substep passes a
    zero [1, wpad, 4] tile and zero levels.  With nc > 0 ntiles is [MAXJ,
    wpad, 4] (aff low, aff high, closest, dist)."""
    if pdata.device.type == "cpu":
        return p2g_plain(pdata, ntiles, btable, jobs, bcells, jbody, cell_width,
                         by, nc)
    wsh, wvol, wpad = R.window_geom(by)
    maxj = jobs["start"].shape[0]
    if (wvol > R.WV_MAX or nc > 16 or ntiles.shape[1:] != (wpad, 4)
            or (nc > 0 and ntiles.shape[0] != maxj)):
        raise ValueError("p2g_tiles: by <= 8, <= 16 colliders and [MAXJ, wpad, 4] "
                         "node tiles ([1, wpad, 4] will do at nc = 0)")
    jt = job_table(jobs, bcells, jbody)
    R.check_kernel_args(pdata, ntiles, btable, jt)
    dev = pdata.device
    mm = torch.empty((maxj, wpad, 8), dtype=torch.float32, device=dev)
    part = torch.empty((maxj, 6, 16), dtype=torch.float32, device=dev)
    imp = torch.zeros((1, 8, 128), dtype=torch.float32, device=dev)
    _cuda.launch("p2g", "p2g_cuda", "pipppiiiffppp", pdata, pdata.shape[1],
                 ntiles, btable, jt, maxj, by, nc, R.f32(cell_width),
                 R.f32(1.0 / cell_width), mm, part, imp)
    p2g_tiles.launches += 1
    return mm, imp


p2g_tiles.launches = 0
