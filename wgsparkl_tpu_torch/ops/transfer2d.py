"""The 2D transfer kernels: particle CDF (kernel G, csrc/pcdf2d.cu), P2G
(kernel H, csrc/p2g2d.cu) and G2P (kernel I, csrc/g2p2d.cu); port of
wgsparkl_tpu/ops/pallas_transfer2d.py `pcdf_rows` / `_pcdf_kernel`,
`p2g_tiles` / `_p2g_kernel` and `g2p_rows` / `_g2p_kernel`.

A job is up to `group` sorted particles of one 8 x 8 block; its window is
the block's 10 x 10 nodes (ops/rows2d.py).  Every kernel reads the job's
gathered node-CDF tiles ntiles [MAXJ, WPAD, 4] (affinity low half, high
half, closest collider, distance) and its gate level jbody: 0 (no collider
node in the window: no particle CDF, plain transfers) or > 0 (CPIC
compatibility masks, ghost velocities and impulses; the 2D path has no
static-only level).  In chan-free mode (`chan_free`, alldesc every
collider in slot order) no tile is read: a gated job evaluates every
collider at its window nodes (window_tiles, the port of
`_moving_node_cdf_2d`; csrc/transfer2d.cuh window_node_cdf2), and ntiles is
a [1, WPAD, 4] dummy.  A scene with no collider (nc = 0) runs P2G and G2P
only, and they read no node tile: the collider-free substep passes one zero
[1, WPAD, 4] tile and zero gate levels.  With `fold_vel`, G2P's grid tiles
hold raw momentum and mass, and the grid update (rows.fold_velocity) is
done on each window node as its tile is read.  The TPU kernels write particle
rows through a sequential-grid VMEM handoff; here each job writes exactly
its own lanes [start, start + len) and G and I write the zeros past them
themselves, from the live jobs covering the lanes [0, end) in one run, as
build_jobs makes them.  G also patches its rows into the sorted particle
rows in place, as the JAX substep's dynamic_update_slice does.

Summation order: a particle's sums over its 3 x 3 stencil nodes run in node
order (ox slowest), a window node's sums over particles in particle order,
and a job's impulse sums over window nodes in node order, in the kernels
and the plain versions alike, so the two agree bit for bit.
"""

from __future__ import annotations

import torch

from wgsparkl_tpu_torch import _cuda
from wgsparkl_tpu_torch.collision.cdf_channel import bit
from wgsparkl_tpu_torch.ops import rows as R
from wgsparkl_tpu_torch.ops import rows2d as R2
from wgsparkl_tpu_torch.ops.blocked import add_rows
from wgsparkl_tpu_torch.ops.p2g_cdf import _seqsum, collider_words, job_table


def window_tiles(btable, bcells, alldesc, cell_width):
    """Chan-free node tiles [MAXJ, WPAD, 4] (aff low, aff high, closest,
    dist): the colliders of alldesc evaluated in order at each job's window
    nodes from the 2D body table (rows.moving_node_cdf: strictly closer
    wins; BIG, 0 and -1 where none), in the gathered tiles' form."""
    xw = R.window_positions(bcells, cell_width, R2.WSH)
    dist, aff, closest = R.moving_node_cdf(xw, btable, alldesc, cell_width)
    t = torch.zeros((bcells.shape[0], R2.WPAD, 4), dtype=torch.float32,
                    device=xw.device)
    t[:, :R2.WVOL] = torch.stack([*R.aff_halves(aff), closest, dist], -1)
    return t


def _pairs(pdata, ntiles, jobs, bcells, cell_width, select=None):
    """Per covered particle (optionally only those of the jobs `select`
    [MAXJ] bool marks): job id, lane, its NCHAN rows, stencil weights,
    window node indices and validity, and per (particle, stencil node)
    the node's affinity word (0 at dropped nodes), closest collider,
    distance and world position [P, 9, 2]."""
    jid, lane = R.job_lanes(jobs)
    if select is not None:
        keep = select[jid]
        jid, lane = jid[keep], lane[keep]
    pd = pdata[:R2.NCHAN, lane]
    bc = bcells.to(torch.int64)[jid]
    w, nidx, valid = R.stencil([pd[0], pd[1]], bc, R.f32(1.0 / cell_width),
                                R2.WSH)
    if ntiles is None:      # no collider: no node affinity, no closest body
        t = torch.zeros(w.shape + (4,), dtype=torch.float32, device=w.device)
        t[..., 2] = -1.0
    else:
        t = ntiles.reshape(-1, 4)[jid[:, None] * R2.WPAD + nidx]
    naff = torch.where(valid, R.aff_from_halves(t[..., 0], t[..., 1]), 0)
    node = torch.stack([nidx // R2.WSH[1], nidx % R2.WSH[1]], -1)
    xw = (node.to(torch.float32) + bc.to(torch.float32)[:, None, :]) * cell_width
    return dict(jid=jid, lane=lane, pd=pd, w=w, nidx=nidx, valid=valid,
                naff=naff, closest=t[..., 2], ndist=t[..., 3], xw=xw)


def _inv3_solve(a, b):
    """Solve the 3x3 system a x = b (entries [P] channels) by cofactors;
    returns (x, det)."""
    c00 = a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1]
    c01 = a[1, 2] * a[2, 0] - a[1, 0] * a[2, 2]
    c02 = a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]
    det = a[0, 0] * c00 + a[0, 1] * c01 + a[0, 2] * c02
    inv_det = torch.where(det.abs() > 1e-30, R.nr_recip(det), 0.0)
    i = {(0, 0): c00,
         (0, 1): a[0, 2] * a[2, 1] - a[0, 1] * a[2, 2],
         (0, 2): a[0, 1] * a[1, 2] - a[0, 2] * a[1, 1],
         (1, 0): c01,
         (1, 1): a[0, 0] * a[2, 2] - a[0, 2] * a[2, 0],
         (1, 2): a[0, 2] * a[1, 0] - a[0, 0] * a[1, 2],
         (2, 0): c02,
         (2, 1): a[0, 1] * a[2, 0] - a[0, 0] * a[2, 1],
         (2, 2): a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]}
    x = [(i[r, 0] * b[0] + i[r, 1] * b[1] + i[r, 2] * b[2]) * inv_det
         for r in range(3)]
    return x, det


def particle_cdf(prev_aff, p, nc: int):
    """Particle CDF from its 9 stencil nodes (_pcdf_body): the affinity
    union over the stencil, per-collider sign votes kept from the previous
    word where it had the collider, and the 3x3 MLS solve for the signed
    distance and normal.  p: a _pairs dict.  Returns (aff int32 [P], sd
    [P], normal 2 x [P])."""
    naff, w, ndist = p["naff"], p["w"], p["ndist"]
    p_bits = torch.zeros_like(prev_aff)
    sign_word = torch.zeros_like(prev_aff)
    dw = ndist * w
    for c in range(nc):
        has_c = ((naff >> c) & 1) != 0
        p_bits = p_bits | torch.where(has_c.any(dim=1), bit(c),
                                      0).to(torch.int32)
        neg = ((naff >> (16 + c)) & 1) != 0
        votes = _seqsum(torch.where(has_c, torch.where(neg, -dw, dw), 0.0))
        new_sign = torch.where(((prev_aff >> c) & 1) != 0,
                               ((prev_aff >> (16 + c)) & 1) != 0, votes < 0.0)
        sign_word = sign_word | torch.where(new_sign, bit(16 + c),
                                            0).to(torch.int32)
    p_aff = p_bits | sign_word
    combined = naff & p_aff[:, None] & 0xFFFF
    sign_diff = (((naff ^ p_aff[:, None]) >> 16) & 0xFFFF) & combined
    wk = torch.where(combined != 0, w, 0.0)
    wks = wk * torch.where(sign_diff == 0, ndist, -ndist)
    dx = [p["xw"][..., k] - p["pd"][k][:, None] for k in range(2)]
    a = {}
    for r in range(2):
        for c in range(r, 2):
            a[r, c] = _seqsum(wk * dx[r] * dx[c])
        a[r, 2] = _seqsum(wk * dx[r])
    a[2, 2] = _seqsum(wk)
    for r in range(3):
        for c in range(r):
            a[r, c] = a[c, r]
    b = [_seqsum(wks * dx[k]) for k in range(2)] + [_seqsum(wks)]
    x, det = _inv3_solve(a, b)
    ok = det > 1e-8
    nlen = torch.sqrt(x[0] * x[0] + x[1] * x[1])
    ninv = torch.where(nlen > 1e-6, R.nr_recip(torch.clamp(nlen, min=1e-30)), 0.0)
    normal = [torch.where(ok, x[k] * ninv, 0.0) for k in range(2)]
    return torch.where(ok, p_aff, 0), torch.where(ok, x[2], 0.0), normal


def pcdf_plain(pdata, ntiles, jobs, bcells, jbody, cell_width, group, npad, nc,
               btable=None, alldesc=(), chan_free=False):
    if chan_free:
        ntiles = window_tiles(btable, bcells, alldesc, cell_width)
    out = torch.zeros((8, npad + group + 128), dtype=torch.float32,
                      device=pdata.device)
    p = _pairs(pdata, ntiles, jobs, bcells, cell_width, select=jbody > 0)
    pd = p["pd"]
    aff, sd, normal = particle_cdf(
        R.aff_from_halves(pd[R2.AFF], pd[R2.AFF_SPARE]), p, nc)
    lo, hi = R.aff_halves(aff)
    lane = p["lane"]
    out[0, lane], out[1, lane], out[4, lane] = lo, sd, hi
    for k in range(2):
        out[2 + k, lane] = normal[k]
    pdata[R2.AFF] = out[0, :npad]
    pdata[R2.NX:R2.NY + 1] = out[2:4, :npad]
    pdata[R2.AFF_SPARE] = out[4, :npad]
    return out


def p2g_plain(pdata, ntiles, btable, jobs, bcells, jbody, cell_width, nc,
              alldesc=(), chan_free=False):
    dev = pdata.device
    if chan_free:
        ntiles = window_tiles(btable, bcells, alldesc, cell_width)
    maxj = jobs["start"].shape[0]
    p = _pairs(pdata, ntiles if nc else None, jobs, bcells, cell_width)
    pd, w, jid = p["pd"], p["w"], p["jid"]
    # Kernel H buckets a particle by its stencil's centre node (base cell +
    # 1) and drops a particle whose centre lies outside its window; the
    # block sort key (blocked.particle_sort_keys_ch) keeps every centre
    # inside.
    if not bool(p["valid"][:, 4].all()):
        raise ValueError("p2g_plain: a particle's stencil centre lies outside "
                         "its job window")
    gated = (jbody.to(torch.int64)[jid] > 0)[:, None]
    paff = R.aff_from_halves(pd[R2.AFF], pd[R2.AFF_SPARE])
    comp = R.compat(p["naff"], paff[:, None])
    wc = torch.where(gated & ~comp, 0.0, w)
    mass = pd[R2.PM]
    A = [pd[R2.A0 + k] for k in range(4)]
    feats = [mass * pd[R2.VX] - (A[0] * pd[R2.PX] + A[1] * pd[R2.PY]),
             mass * pd[R2.VY] - (A[2] * pd[R2.PX] + A[3] * pd[R2.PY]),
             mass] + A
    fi = (jid[:, None] * R2.WVOL + p["nidx"]).reshape(-1)
    acc = torch.zeros((maxj * R2.WVOL, 7), dtype=torch.float32, device=dev)
    add_rows(acc, fi, (wc[:, :, None] * torch.stack(feats, 1)[:, None, :])
             .reshape(-1, 7))
    acc = acc.reshape(maxj, R2.WVOL, 7)
    node = R.window_offsets(R2.WSH, dev).to(torch.float32)
    xw = (node[None] + bcells.to(torch.float32)[:, None, :]) * cell_width
    mm = torch.zeros((maxj, R2.WPAD, 8), dtype=torch.float32, device=dev)
    for i in range(2):
        mm[:, :R2.WVOL, i] = (acc[..., i] + acc[..., 3 + 2 * i] * xw[..., 0]
                              + acc[..., 4 + 2 * i] * xw[..., 1])
    mm[:, :R2.WVOL, 2] = acc[..., 2]

    # Impulses of the incompatible (node, particle) pairs of gated jobs.
    imp = torch.zeros((maxj, 8, 128), dtype=torch.float32, device=dev)
    if nc == 0:
        return mm, imp
    closest_w = ntiles[:, :R2.WVOL, 2]
    bv = [b.reshape(-1)[fi].reshape(w.shape)
          for b in R2.node_body_velocity(closest_w, xw, btable, nc)]
    vp = [pd[R2.VX][:, None], pd[R2.VY][:, None]]
    ghost = R.ghost_velocity(vp, bv, [pd[R2.NX][:, None], pd[R2.NY][:, None]])
    w_i = torch.where(comp | (p["closest"] < 0.0) | ~gated, 0.0, w) * mass[:, None]
    dsum = torch.zeros((maxj * R2.WVOL, 2), dtype=torch.float32, device=dev)
    add_rows(dsum, fi, torch.stack([w_i * (vp[k] - ghost[k]) for k in range(2)],
                                   -1).reshape(-1, 2))
    dsum = dsum.reshape(maxj, R2.WVOL, 2)
    cr = dsum[..., 0] * xw[..., 1] - dsum[..., 1] * xw[..., 0]
    vals = torch.stack([dsum[..., 0], dsum[..., 1], cr], -1)        # [J, W, 3]
    job2 = (jbody > 0) & (jobs["len"] > 0)
    mask = torch.stack([(closest_w == b) & job2[:, None] for b in range(nc)],
                       -1).to(torch.float32)                        # [J, W, nc]
    s = torch.zeros((maxj, 3, nc), dtype=torch.float32, device=dev)
    for n in range(R2.WVOL):
        s = s + vals[:, n, :, None] * mask[:, n, None, :]
    com = btable[0:2, :nc]
    imp[:, 0:2, :nc] = s[:, 0:2]
    imp[:, 2, :nc] = s[:, 0] * com[1] - s[:, 1] * com[0] - s[:, 2]
    return mm, imp


def g2p_plain(pdata, ftiles, ntiles, btable, jobs, bcells, jbody, cell_width,
              group, npad, nc, alldesc=(), chan_free=False, fold_vel=False):
    if chan_free:
        ntiles = window_tiles(btable, bcells, alldesc, cell_width)
    if fold_vel:
        ftiles = R.fold_velocity(ftiles, btable, 2, 13)
    p = _pairs(pdata, ntiles if nc else None, jobs, bcells, cell_width)
    pd, w, jid = p["pd"], p["w"], p["jid"]
    ft = ftiles.reshape(-1, 4)[jid[:, None] * R2.WPAD + p["nidx"]]
    v = [ft[..., 0], ft[..., 1]]
    x = [p["xw"][..., 0], p["xw"][..., 1]]
    gated = jbody.to(torch.int64)[jid] > 0
    paff = R.aff_from_halves(pd[R2.AFF], pd[R2.AFF_SPARE])
    wc = torch.where(gated[:, None] & ~R.compat(p["naff"], paff[:, None]), 0.0, w)
    rows = [_seqsum(wc * v[i]) for i in range(2)]
    rows += [_seqsum(wc * (v[i] * x[k])) for i in range(2) for k in range(2)]
    if nc > 0:
        wi = w - wc
        closest = p["closest"]
        bv = R2.node_body_velocity(closest, p["xw"], btable, nc)
        vp = [pd[R2.VX][:, None], pd[R2.VY][:, None]]
        gb = R.ghost_velocity(vp, bv, [pd[R2.NX][:, None], pd[R2.NY][:, None]])
        g = [torch.where(closest >= 0.0, gb[i], vp[i]) for i in range(2)]
        extra = [_seqsum(wi * g[i]) for i in range(2)]
        extra += [_seqsum(wi * g[i] * x[k]) for i in range(2) for k in range(2)]
        rows = [torch.where(gated, r + e, r) for r, e in zip(rows, extra)]
    out = torch.zeros((8, npad + group + 128), dtype=torch.float32,
                      device=pdata.device)
    out[:6, p["lane"]] = torch.stack(rows, 0)
    return out


# ------------------------------------------------------------- the wrappers
def _check_tiles(name, maxj, nc, chan_free, ntiles, *tiles):
    """Node tiles [MAXJ, WPAD, 4] ([1, WPAD, 4] in chan-free mode, any
    [., WPAD, 4] at nc = 0, where they are not read) and grid tiles [MAXJ,
    WPAD, 4]."""
    if (nc > 16 or ntiles.shape[1:] != (R2.WPAD, 4)
            or (nc > 0 and ntiles.shape[0] != (1 if chan_free else maxj))
            or any(t.shape != (maxj, R2.WPAD, 4) for t in tiles)):
        raise ValueError(f"{name}: <= 16 colliders and [MAXJ, {R2.WPAD}, 4] "
                         "tiles ([1, WPAD, 4] node tiles in chan-free mode)")


def _shapes(nc, alldesc, chan_free) -> int:
    """The kernels' shape word (2 bits a slot) in chan-free mode, where
    alldesc must list the colliders 0..nc-1 in slot order; 0 otherwise."""
    if not chan_free:
        return 0
    if [slot for slot, _ in alldesc] != list(range(nc)):
        raise ValueError("chan-free: alldesc must list every collider in slot order")
    return collider_words(alldesc)[2]


def pcdf_rows(pdata, ntiles, jobs, bcells, jbody, cell_width: float, group: int,
              npad: int, nc: int, btable=None, alldesc=(),
              chan_free: bool = False):
    """Particle-CDF rows [8, NPAD + G + 128]: aff low, signed distance,
    normal xy, aff high (row 4), on the lanes of gated jobs (zero
    elsewhere).  pdata: the sorted rows [>= NCHAN, NPAD] (rows 0..15 are
    read), patched in place: its rows AFF, NX, NY, AFF_SPARE take rows 0,
    2, 3, 4 of the result on every lane, after its affinity rows were read
    (pass a clone to keep them); btable: the 2D body table, read only in
    chan-free mode."""
    if pdata.device.type == "cpu":
        return pcdf_plain(pdata, ntiles, jobs, bcells, jbody, cell_width, group,
                          npad, nc, btable, alldesc, chan_free)
    maxj = jobs["start"].shape[0]
    _check_tiles("pcdf_rows", maxj, nc, chan_free, ntiles)
    if maxj < 1:
        raise ValueError("pcdf_rows: the kernel writes its output from >= 1 job slot")
    if pdata.dtype != torch.float32 or pdata.dim() != 2 or pdata.shape[0] < R2.NCHAN \
            or pdata.shape[1] != npad:
        raise ValueError(f"pcdf_rows: pdata must be f32 [>= {R2.NCHAN}, {npad}] rows")
    shapes = _shapes(nc, alldesc, chan_free)
    if btable is None:
        if chan_free:
            raise ValueError("pcdf_rows: chan-free mode reads the body table")
        btable = ntiles                     # a pointer the kernel does not read
    jt = job_table(jobs, bcells, jbody)
    R.check_kernel_args(pdata, ntiles, btable, jt)
    # The kernel writes every entry: the live jobs' lanes, and 0 past them.
    out = torch.empty((8, npad + group + 128), dtype=torch.float32,
                      device=pdata.device)
    _cuda.launch("pcdf2d", "pcdf2d_cuda", "pipppiiiifffpi", pdata, pdata.shape[1],
                 ntiles, btable, jt, maxj, nc, shapes, int(chan_free),
                 R.f32(cell_width), R.f32(1.0 / cell_width),
                 R.f32(1.5 * cell_width), out, out.shape[1])
    pcdf_rows.launches += 1
    return out


def p2g_tiles(pdata, ntiles, btable, jobs, bcells, jbody, cell_width: float,
              nc: int, alldesc=(), chan_free: bool = False):
    """(mm [MAXJ, WPAD, 8]: cols 0-1 momentum, 2 mass; imp [MAXJ, 8, 128]:
    rows 0-1 linear, 2 angular impulse per collider lane).  pdata: the
    sorted rows with the fresh particle CDF patched in."""
    if pdata.device.type == "cpu":
        return p2g_plain(pdata, ntiles, btable, jobs, bcells, jbody, cell_width,
                         nc, alldesc, chan_free)
    maxj = jobs["start"].shape[0]
    _check_tiles("p2g_tiles", maxj, nc, chan_free, ntiles)
    shapes = _shapes(nc, alldesc, chan_free)
    jt = job_table(jobs, bcells, jbody)
    R.check_kernel_args(pdata, ntiles, btable, jt)
    dev = pdata.device
    mm = torch.empty((maxj, R2.WPAD, 8), dtype=torch.float32, device=dev)
    imp = torch.zeros((maxj, 8, 128), dtype=torch.float32, device=dev)
    _cuda.launch("p2g2d", "p2g2d_cuda", "pipppiiiifffpp", pdata, pdata.shape[1],
                 ntiles, btable, jt, maxj, nc, shapes, int(chan_free),
                 R.f32(cell_width), R.f32(1.0 / cell_width),
                 R.f32(1.5 * cell_width), mm, imp)
    p2g_tiles.launches += 1
    return mm, imp


def g2p_rows(pdata, ftiles, ntiles, btable, jobs, bcells, jbody,
             cell_width: float, group: int, npad: int, nc: int, alldesc=(),
             chan_free: bool = False, fold_vel: bool = False):
    """G2P rows [8, NPAD + G + 128]: rows 0-1 PIC velocity, 2-5 the
    velocity moment (row 2 + 2 i + k = sum w v_i x_k).  ftiles [MAXJ, WPAD,
    4]: the gathered grid velocity (cols 0-1) and mass (col 2), or with
    fold_vel the raw momentum and mass."""
    if pdata.device.type == "cpu":
        return g2p_plain(pdata, ftiles, ntiles, btable, jobs, bcells, jbody,
                         cell_width, group, npad, nc, alldesc, chan_free,
                         fold_vel)
    maxj = jobs["start"].shape[0]
    _check_tiles("g2p_rows", maxj, nc, chan_free, ntiles, ftiles)
    if maxj < 1:
        raise ValueError("g2p_rows: the kernel writes its output from >= 1 job slot")
    shapes = _shapes(nc, alldesc, chan_free)
    jt = job_table(jobs, bcells, jbody)
    R.check_kernel_args(pdata, ftiles, ntiles, btable, jt)
    # The kernel writes every entry: the live jobs' lanes, and 0 past them.
    out = torch.empty((8, npad + group + 128), dtype=torch.float32,
                      device=pdata.device)
    _cuda.launch("g2p2d", "g2p2d_cuda", "pippppiiiiifffpi", pdata,
                 pdata.shape[1], ftiles, ntiles, btable, jt, maxj, nc, shapes,
                 int(chan_free), int(fold_vel), R.f32(cell_width),
                 R.f32(1.0 / cell_width), R.f32(1.5 * cell_width), out,
                 out.shape[1])
    g2p_rows.launches += 1
    return out


pcdf_rows.launches = 0
p2g_tiles.launches = 0
g2p_rows.launches = 0
