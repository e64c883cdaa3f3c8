"""Fused particle CDF + P2G (port of wgsparkl_tpu/ops/pallas_cdf.py,
`p2g_cdf_tiles` and its body `_p2g_cdf_kernel` / `_pcdf_body`; kernel A,
csrc/p2g_cdf.cu).

Per job (up to `group` sorted particles of one block) and per particle,
over its 3^3 stencil inside the job's window:

  * the particle CDF (g2p_cdf.wgsl): the union of the nodes' affinity bits,
    per-collider sign votes with temporal persistence from the previous
    affinity word, and the MLS signed distance + normal from a 4x4 solve;
  * the CPIC-masked APIC P2G of momentum and mass into the job's window
    tile [wpad, 8] (cols 0-2 momentum, 3 mass), each node's pairs summed
    in the lists order of csrc/transfer.cuh (rows.lists_order): offsets in
    stencil order, each offset's particles in particle order, per chunk of
    up to 1024 particles of a job;
  * at gate level 2 the impulses of incompatible (node, particle) pairs
    against the node's closest body, each node's pairs in the lists order,
    reduced per job and collider over the window nodes in node order, then
    over the jobs in job order (the kernel's order: a dynamic body's
    velocity follows from them, so the kernel path and the plain path keep
    the same bits).

Gate levels (per job): 0 no collider node in the window (no CDF, plain
P2G), 1 only frame-static colliders, 2 a moving collider may be in reach
(plus impulses).  The window node CDF comes from the gathered channels
(level 1), merged at level 2 with the in-kernel CDF of the moving
colliders; in chan-free mode no tile is read and the kernel evaluates the
static colliders at level 1 and all colliders at level 2.  The TPU
version writes particle rows through a sequential-grid VMEM handoff; here
each job writes exactly its own lanes [start, start + len) and the rest of
the output stays zero.
"""

from __future__ import annotations

import torch

from wgsparkl_tpu_torch import _cuda
from wgsparkl_tpu_torch.collision.cdf_channel import bit
from wgsparkl_tpu_torch.ops import rows as R
from wgsparkl_tpu_torch.ops.blocked import add_rows


def _seqsum(terms):
    """Sum over the last axis in index order (the kernels' order)."""
    acc = torch.zeros_like(terms[..., 0])
    for o in range(terms.shape[-1]):
        acc = acc + terms[..., o]
    return acc


def inv4_solve(a, b):
    """Solve the 4x4 system a x = b (entries [P] channels) by cofactors;
    returns (x, det)."""
    s0 = a[0, 0] * a[1, 1] - a[1, 0] * a[0, 1]
    s1 = a[0, 0] * a[1, 2] - a[1, 0] * a[0, 2]
    s2 = a[0, 0] * a[1, 3] - a[1, 0] * a[0, 3]
    s3 = a[0, 1] * a[1, 2] - a[1, 1] * a[0, 2]
    s4 = a[0, 1] * a[1, 3] - a[1, 1] * a[0, 3]
    s5 = a[0, 2] * a[1, 3] - a[1, 2] * a[0, 3]
    c5 = a[2, 2] * a[3, 3] - a[3, 2] * a[2, 3]
    c4 = a[2, 1] * a[3, 3] - a[3, 1] * a[2, 3]
    c3 = a[2, 1] * a[3, 2] - a[3, 1] * a[2, 2]
    c2 = a[2, 0] * a[3, 3] - a[3, 0] * a[2, 3]
    c1 = a[2, 0] * a[3, 2] - a[3, 0] * a[2, 2]
    c0 = a[2, 0] * a[3, 1] - a[3, 0] * a[2, 1]
    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    i = {}
    i[0, 0] = a[1, 1] * c5 - a[1, 2] * c4 + a[1, 3] * c3
    i[0, 1] = -a[0, 1] * c5 + a[0, 2] * c4 - a[0, 3] * c3
    i[0, 2] = a[3, 1] * s5 - a[3, 2] * s4 + a[3, 3] * s3
    i[0, 3] = -a[2, 1] * s5 + a[2, 2] * s4 - a[2, 3] * s3
    i[1, 0] = -a[1, 0] * c5 + a[1, 2] * c2 - a[1, 3] * c1
    i[1, 1] = a[0, 0] * c5 - a[0, 2] * c2 + a[0, 3] * c1
    i[1, 2] = -a[3, 0] * s5 + a[3, 2] * s2 - a[3, 3] * s1
    i[1, 3] = a[2, 0] * s5 - a[2, 2] * s2 + a[2, 3] * s1
    i[2, 0] = a[1, 0] * c4 - a[1, 1] * c2 + a[1, 3] * c0
    i[2, 1] = -a[0, 0] * c4 + a[0, 1] * c2 - a[0, 3] * c0
    i[2, 2] = a[3, 0] * s4 - a[3, 1] * s2 + a[3, 3] * s0
    i[2, 3] = -a[2, 0] * s4 + a[2, 1] * s2 - a[2, 3] * s0
    i[3, 0] = -a[1, 0] * c3 + a[1, 1] * c1 - a[1, 2] * c0
    i[3, 1] = a[0, 0] * c3 - a[0, 1] * c1 + a[0, 2] * c0
    i[3, 2] = -a[3, 0] * s3 + a[3, 1] * s1 - a[3, 2] * s0
    i[3, 3] = a[2, 0] * s3 - a[2, 1] * s1 + a[2, 2] * s0
    inv_det = torch.where(det.abs() > 1e-30, R.nr_recip(det), 0.0)
    x = [(i[r, 0] * b[0] + i[r, 1] * b[1] + i[r, 2] * b[2] + i[r, 3] * b[3])
         * inv_det for r in range(4)]
    return x, det


def particle_cdf(pd, prev_aff, naff, ndist, w, xl, pl_, nc: int):
    """Particle CDF from its 27 stencil nodes (_pcdf_body).

    naff int32 / ndist / w [P, 27]; xl [P, 27, 3] node positions and pl_
    [3][P] the particle position, both relative to the block origin.
    Returns (aff int32 [P], sd [P], normal 3 x [P])."""
    p_bits = torch.zeros_like(prev_aff)
    sign_word = torch.zeros_like(prev_aff)
    dw = ndist * w
    for c in range(nc):
        has_c = ((naff >> c) & 1) != 0
        present = has_c.any(dim=1)
        p_bits = p_bits | torch.where(present, bit(c), 0).to(torch.int32)
        neg = ((naff >> (16 + c)) & 1) != 0
        votes = _seqsum(torch.where(has_c, torch.where(neg, -dw, dw), 0.0))
        prev_has = ((prev_aff >> c) & 1) != 0
        prev_sign = ((prev_aff >> (16 + c)) & 1) != 0
        new_sign = torch.where(prev_has, prev_sign, votes < 0.0)
        sign_word = sign_word | torch.where(new_sign, bit(16 + c), 0).to(torch.int32)
    p_aff = p_bits | sign_word
    combined = naff & p_aff[:, None] & 0xFFFF
    sign_diff = (((naff ^ p_aff[:, None]) >> 16) & 0xFFFF) & combined
    wk = torch.where(combined != 0, w, 0.0)
    wks = wk * torch.where(sign_diff == 0, ndist, -ndist)
    x0, x1, x2 = xl[..., 0], xl[..., 1], xl[..., 2]
    mono = [None, x0, x1, x2, x0 * x0, x0 * x1, x0 * x2, x1 * x1, x1 * x2, x2 * x2]
    smom = [_seqsum(wk)] + [_seqsum(m * wk) for m in mono[1:]]
    tmom = [_seqsum(wks)] + [_seqsum(m * wks) for m in mono[1:4]]
    pair = {(0, 0): 4, (0, 1): 5, (0, 2): 6, (1, 1): 7, (1, 2): 8, (2, 2): 9}
    a = {}
    for r in range(3):
        for c in range(r, 3):
            a[r, c] = (smom[pair[r, c]] - pl_[r] * smom[1 + c]
                       - pl_[c] * smom[1 + r] + pl_[r] * pl_[c] * smom[0])
        a[r, 3] = smom[1 + r] - pl_[r] * smom[0]
    a[3, 3] = smom[0]
    for r in range(4):
        for c in range(r):
            a[r, c] = a[c, r]
    b = [tmom[1 + k] - pl_[k] * tmom[0] for k in range(3)] + [tmom[0]]
    x, det = inv4_solve(a, b)
    ok = det > 1e-8
    nlen = torch.sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2])
    ninv = torch.where(nlen > 1e-6, R.nr_recip(torch.clamp(nlen, min=1e-30)), 0.0)
    normal = [torch.where(ok, x[k] * ninv, 0.0) for k in range(3)]
    return (torch.where(ok, p_aff, 0), torch.where(ok, x[3], 0.0), normal)


def p2g_features(pd):
    """Kernel A's 13 P2G features of each particle (rows pd [>=16, P]):
    m v - A x_p, m, and A[a][k] at 4 + 3k + a."""
    mass = pd[R.PM]
    A = [[pd[R.A0 + 3 * i + k] for k in range(3)] for i in range(3)]
    feats = []
    for i in range(3):
        ap = A[i][0] * pd[R.PX] + A[i][1] * pd[R.PY] + A[i][2] * pd[R.PZ]
        feats.append(mass * pd[R.VX + i] - ap)
    feats.append(mass)
    return feats + [A[i][k] for k in range(3) for i in range(3)]


def window_tile(acc, xw, wpad: int):
    """[J, wpad, 8] tiles from the node sums acc [J, wvol, 13] of
    p2g_features: cols 0-2 momentum (recombined with the node positions xw
    [J, wvol, 3]), 3 mass, 4-7 zero."""
    maxj, wvol, _ = acc.shape
    mm = torch.zeros((maxj, wpad, 8), dtype=torch.float32, device=acc.device)
    for i in range(3):
        mm[:, :wvol, i] = (acc[..., i] + xw[..., 0] * acc[..., 4 + i]
                           + xw[..., 1] * acc[..., 7 + i]
                           + xw[..., 2] * acc[..., 10 + i])
    mm[:, :wvol, 3] = acc[..., 3]
    return mm


def p2g_node_tiles(pd, w, fi, xw, wpad: int, order=None):
    """[J, wpad, 8] tiles of kernel A's P2G form: each (particle, stencil
    offset) pair adds w [P, 27] times the particle's p2g_features (rows pd)
    to its flat window node fi [P, 27] (job * wvol + node), each node's
    pairs in `order` (a permutation of the flattened pairs, rows.lists_order;
    None: particle order), then window_tile with the node positions xw
    [J, wvol, 3]."""
    maxj, wvol, _ = xw.shape
    contrib = (w[:, :, None] * torch.stack(p2g_features(pd), 1)[:, None, :]).reshape(-1, 13)
    fi = fi.reshape(-1)
    if order is not None:
        fi, contrib = fi[order], contrib[order]
    acc = torch.zeros((maxj * wvol, 13), dtype=torch.float32, device=pd.device)
    add_rows(acc, fi, contrib)
    return window_tile(acc.reshape(maxj, wvol, 13), xw, wpad)


def p2g_cdf_plain(pdata, ntiles, btable, jobs, bcells, jbody, cell_width,
                  by, group, npad, nc, moving=(), static_desc=(), chan_free=False):
    dev = pdata.device
    wsh, wvol, wpad = R.window_geom(by)
    maxj = jobs["start"].shape[0]
    jid, lane = R.job_lanes(jobs)
    lvl = jbody.to(torch.int64)[jid]
    xw = R.window_positions(bcells, cell_width, wsh)
    naff_w, closest_w, ndist_w = R.window_cdf(ntiles, xw, btable, moving, jbody,
                                              cell_width, wvol, static_desc,
                                              chan_free)
    pd = pdata[:R.NCHAN, lane]
    bc = bcells.to(torch.int64)[jid]
    inv_h = float(torch.tensor(1.0 / cell_width, dtype=torch.float32))
    w, nidx, valid = R.stencil([pd[0], pd[1], pd[2]], bc, inv_h, wsh)
    fi = jid[:, None] * wvol + nidx
    naff = torch.where(valid, naff_w.reshape(-1)[fi], 0)
    closest = closest_w.reshape(-1)[fi]
    ndist = ndist_w.reshape(-1)[fi]
    xwp = xw.reshape(-1, 3)[fi]

    offs = bc.to(torch.float32) * cell_width
    xl = xwp - offs[:, None, :]
    pl_ = [pd[k] - offs[:, k] for k in range(3)]
    prev_aff = R.aff_from_halves(pd[R.AFF], pd[R.AFF_SPARE])
    aff, sd, normal = particle_cdf(pd, prev_aff, naff, ndist, w, xl, pl_, nc)
    gated = lvl > 0
    aff = torch.where(gated, aff, 0)
    sd = torch.where(gated, sd, 0.0)
    normal = [torch.where(gated, n, 0.0) for n in normal]

    # P2G: compat-masked weights at levels 1-2, plain weights at level 0.
    comp = R.compat(naff, aff[:, None])
    wc = torch.where(gated[:, None] & ~comp, 0.0, w)
    mass = pd[R.PM]
    # Each node's pairs are added in the kernel's lists order.
    order = R.lists_order(jid, jobs["len"])
    mm = p2g_node_tiles(pd, wc, fi, xw, wpad, order)

    # Level-2 impulses against each incompatible node's closest body.
    imp = torch.zeros((1, 8, 128), dtype=torch.float32, device=dev)
    if nc > 0:
        bv_w = R.node_body_velocity(closest_w, xw, btable, nc)
        bvp = [b.reshape(-1)[fi] for b in bv_w]
        vp = [pd[R.VX + k][:, None] for k in range(3)]
        ghost = R.ghost_velocity(vp, bvp, [n[:, None] for n in normal])
        lv2 = (lvl >= 2)[:, None]
        w_i = torch.where(comp | (closest < 0) | ~lv2, 0.0, w) * mass[:, None]
        d = torch.stack([w_i * (vp[k] - ghost[k]) for k in range(3)], -1)
        dsum = torch.zeros((maxj * wvol, 3), dtype=torch.float32, device=dev)
        add_rows(dsum, fi.reshape(-1)[order], d.reshape(-1, 3)[order])
        dsum = dsum.reshape(maxj, wvol, 3)
        x = xw
        cr = torch.stack([
            dsum[..., 1] * x[..., 2] - dsum[..., 2] * x[..., 1],
            dsum[..., 2] * x[..., 0] - dsum[..., 0] * x[..., 2],
            dsum[..., 0] * x[..., 1] - dsum[..., 1] * x[..., 0]], -1)
        job2 = (jbody >= 2) & (jobs["len"] > 0)
        slots = torch.arange(nc, device=dev)
        # Per job and collider [J, nc, 3]: the nodes in window order.
        db = torch.zeros((maxj, nc, 3), dtype=torch.float32, device=dev)
        cb = torch.zeros_like(db)
        for n in range(wvol):
            m = ((closest_w[:, n, None] == slots) & job2[:, None]).to(torch.float32)
            db = db + dsum[:, n, None, :] * m[..., None]
            cb = cb + cr[:, n, None, :] * m[..., None]
        com = [btable[k, :nc] for k in range(3)]
        part = torch.stack([db[..., 0], db[..., 1], db[..., 2],
                            db[..., 1] * com[2] - db[..., 2] * com[1] - cb[..., 0],
                            db[..., 2] * com[0] - db[..., 0] * com[2] - cb[..., 1],
                            db[..., 0] * com[1] - db[..., 1] * com[0] - cb[..., 2]], 1)
        # Then the jobs in job order.
        acc = torch.zeros((6, nc), dtype=torch.float32, device=dev)
        for j in range(maxj):
            acc = acc + part[j]
        imp[0, 0:6, :nc] = acc

    pcdf = torch.zeros((8, npad + group + 128), dtype=torch.float32, device=dev)
    lo, hi = R.aff_halves(aff)
    pcdf[0, lane], pcdf[1, lane], pcdf[5, lane] = lo, sd, hi
    for k in range(3):
        pcdf[2 + k, lane] = normal[k]
    return mm, imp, pcdf


def job_table(jobs, bcells, jbody):
    """[6, MAXJ] int32: start, len, block cell x/y/z (z = 0 in 2D), gate
    level."""
    bz = bcells[:, 2] if bcells.shape[1] == 3 else torch.zeros_like(bcells[:, 0])
    return torch.stack([jobs["start"], jobs["len"], bcells[:, 0], bcells[:, 1],
                        bz, jbody]).to(torch.int32).contiguous()


def collider_words(moving, static_desc=()) -> tuple:
    """The kernels' collider arguments: (moving slot mask, static slot
    mask, shape types packed 2 bits a slot).  The kernels evaluate
    analytic colliders only; a mesh reaches them through the node tiles
    (the mesh pass, ops/rigid_cdf.py)."""
    mov = sta = shapes = 0
    for slot, st in moving:
        mov |= 1 << slot
    for slot, st in static_desc:
        sta |= 1 << slot
    for slot, st in tuple(moving) + tuple(static_desc):
        if not 0 <= st <= 3:
            raise ValueError(
                f"collider shape {st} is a mesh: the kernels take analytic "
                "colliders only (meshes arrive through the node tiles)")
        shapes |= st << (2 * slot)
    return mov, sta, shapes


def check_node_tiles(name, ntiles, maxj, wpad, chan_free):
    """[MAXJ, wpad, 4] gathered node tiles; [1, wpad, 4] in chan-free mode
    (not read)."""
    want = (1 if chan_free else maxj, wpad, 4)
    if tuple(ntiles.shape) != want:
        raise ValueError(f"{name}: node tiles {tuple(ntiles.shape)}, want {want}")


def p2g_cdf_tiles(pdata, ntiles, btable, jobs, bcells, jbody, cell_width: float,
                  by: int, group: int, npad: int, nc: int, moving=(),
                  static_desc=(), chan_free: bool = False):
    """Returns (mm [MAXJ, wpad, 8], imp [1, 8, 128] rows 0-2 linear / 3-5
    angular impulse per collider lane, pcdf rows [8, NPAD + G + 128]: aff
    low, signed distance, normal xyz, aff high).  pdata: the sorted rows
    (rows 0..23 are read); ntiles [MAXJ, wpad, 4] gathered node channels
    (aff low, aff high, closest, dist), [1, wpad, 4] and unread in chan-free
    mode; moving / static_desc: ((slot, shape), ...) of the moving and the
    never-moving colliders (see the module docstring)."""
    if pdata.device.type == "cpu":
        return p2g_cdf_plain(pdata, ntiles, btable, jobs, bcells, jbody,
                             cell_width, by, group, npad, nc, moving,
                             static_desc, chan_free)
    wsh, wvol, wpad = R.window_geom(by)
    maxj = jobs["start"].shape[0]
    if wvol > R.WV_MAX or nc > 16:
        raise ValueError("p2g_cdf_tiles: by <= 8 and <= 16 colliders")
    check_node_tiles("p2g_cdf_tiles", ntiles, maxj, wpad, chan_free)
    jt = job_table(jobs, bcells, jbody)
    R.check_kernel_args(pdata, ntiles, btable, jt)
    dev = pdata.device
    mm = torch.empty((maxj, wpad, 8), dtype=torch.float32, device=dev)
    part = torch.empty((maxj, 6, 16), dtype=torch.float32, device=dev)
    imp = torch.zeros((1, 8, 128), dtype=torch.float32, device=dev)
    pcdf = torch.zeros((8, npad + group + 128), dtype=torch.float32, device=dev)
    _cuda.launch("p2g_cdf", "p2g_cdf_cuda", "pipppiiiiiiifffippppi",
                 pdata, pdata.shape[1], ntiles, btable, jt, maxj, by, nc,
                 *collider_words(moving, static_desc), int(chan_free),
                 R.f32(cell_width), R.f32(1.0 / cell_width),
                 R.f32(1.5 * cell_width), min(group, R.LIST_CHUNK), mm, part, imp,
                 pcdf, pcdf.shape[1])
    p2g_cdf_tiles.launches += 1
    return mm, imp, pcdf


p2g_cdf_tiles.launches = 0
