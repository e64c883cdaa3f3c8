"""The yardstick of the kernels: the H100's published peaks and the bytes and
f32 operations that each hand-written kernel of a substep needs, frozen
copies of chip_smoke.py's `bound` and per-kernel cost functions (its phase
5's `c_cost`, `g2p_cost`, `p2g2d_cost`, `g2p2d_cost`, `pcdf2d_cost`, the
A, D, E and mesh-pass costs written inline there, and its CDF_OPS), without
the branches (folded grids, chan-free tiles) that these cells never run.
In the gathered-hybrid mode kernels A and B also evaluate each moving
analytic collider's node CDF at every window node of a gate-level-2 job
(chip_smoke.py's `evals`, CDF_OPS operations each).

A bound is the least time the card could take: the larger of the bytes
over 3.35 TB/s and the operations over 67 TFLOP/s.  Each input byte is
counted once and each output byte once; the counts come from one
substep's job table (the program's own record of the substep).
"""

from __future__ import annotations

PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12   # H100 SXM: fp32 (no tensor cores), HBM3
# Operations of one 3D collider's CDF at a node (transfer.cuh collider_cdf:
# two quaternion rotations, the projection, the reach, the distance).
CDF_OPS = 90
# Rows of the row matrix kernel C reads on every lane (ops/rows.py layouts).
C_ROWS_READ_3D = (*range(0, 3), 6, *range(21, 40), *range(44, 48))
C_ROWS_READ_2D = (0, 1, 4, *range(13, 24), *range(27, 32))


def bound(nbytes: float, flops: float) -> float:
    """The least milliseconds to move nbytes and do flops f32 operations."""
    return 1e3 * max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS)


def c_cost(rows_read, krows, pcdf_rows, pchan, npad, ce, flops_per_lane):
    """Kernel C: rows_read rows and the sorted id on every lane, all pchan
    rows written; the ce covered lanes read krows G2P rows and pcdf_rows
    particle-CDF rows."""
    return (4 * ((len(rows_read) + 1 + pchan) * npad + (krows + pcdf_rows) * ce),
            ce * flops_per_lane)


def a_cost(ce, pg, nj, njg, nc, wv, evals=0):
    """Kernel A (3D particle CDF + P2G with impulses); evals node-collider
    CDF evaluations in the kernel."""
    return (4 * (24 * ce + nj * wv * 4 + nj * wv * 8 + 8 * ce + njg * 8 * 128),
            ce * (30 + 27 * 13 * 2) + pg * (27 * (3 * nc + 58) + 200) + evals * CDF_OPS)


def g2p_cost(ce, pg, nj, njg, wv, evals=0):
    """Kernel B (3D G2P) on node tiles, unfolded; evals as for A."""
    return (4 * (3 * ce + 8 * pg + nj * wv * 3 + njg * wv * 4 + 12 * ce),
            ce * (30 + 27 * 24) + pg * 27 * 40 + evals * CDF_OPS)


def moving_evals(st: dict) -> int:
    """Kernels A's and B's node-CDF evaluations of the moving colliders in
    one substep: every window node of a live gate-level-2 job against each
    moving collider that the kernels evaluate (0 with none)."""
    return st["wv"] * st["nj2"] * st["n_moving"]


def p2g2d_cost(ce, pg, nj, njg, nc):
    """Kernel H (2D P2G with impulses) on node tiles."""
    return (4 * (9 * ce + 4 * pg + njg * 100 * 3 + nj * 100 * 3 + njg * 3 * nc),
            ce * (20 + 9 * 7 * 2) + pg * 9 * 31)


def g2p2d_cost(ce, pg, nj, njg, width):
    """Kernel I (2D G2P) on node tiles, unfolded."""
    return (4 * (2 * ce + 6 * pg + nj * 100 * 2 + njg * 100 * 3 + 8 * width),
            ce * (12 + 9 * 16) + pg * 9 * 37)


def pcdf2d_cost(pg, njg, nc, width, npad):
    """Kernel G (2D particle CDF on node tiles, patching the sorted rows)."""
    return (4 * (4 * pg + njg * 100 * 3 + 8 * width + 4 * npad),
            pg * (9 * (3 * nc + 22) + 80))


def permute_cost(rows, npad):
    """Kernel D: every row of every lane read and written, the permutation
    read."""
    return 4 * (2 * rows * npad + npad), 0


def compact_cost(npad, n_first, cap):
    """Kernel E: a byte of flag a lane, each flagged lane's value, (R + 1)
    rows of cap columns out (R = 1)."""
    return npad + 4 * n_first + 4 * 2 * cap, 0


def mesh_cost(samples, vertices_numel, nodes, pairs, d):
    """The mesh pass: samples, primitives, slots and vertices read once, the
    key and word grids written once; ~60 (3D) / 10 (2D) operations a sample
    and ~35 / 15 a sample-node pair."""
    return (4 * (samples * (2 * d + 1) + vertices_numel) + 8 * nodes,
            samples * (60 if d == 3 else 10) + pairs * (35 if d == 3 else 15))


def substep_bounds(st: dict) -> dict:
    """Bound ms of each hand-written kernel of one pallas substep, keyed by
    its csrc/ source: st holds the substep's counts (dim, covered lanes
    ce, of them in gated jobs pg, live jobs nj, gated live jobs njg,
    colliders nc, lanes npad, rows of the row matrix pchan, window volume
    wv, the job size group, distinct sorted block ids n_first, grid blocks
    nb_total, in 3D the live gate-level-2 jobs nj2 and the moving colliders
    evaluated in the kernels n_moving, mesh samples, their vertex floats,
    sample-node pairs and grid nodes)."""
    d, ce, pg, nj, njg = st["dim"], st["ce"], st["pg"], st["nj"], st["njg"]
    nc, npad, pchan = st["nc"], st["npad"], st["pchan"]
    out = {
        "permute": bound(*permute_cost(pchan, npad)),
        "compact": bound(*compact_cost(npad, st["n_first"], min(st["nb_total"] + 3, npad))),
    }
    if st.get("samples"):
        out["mesh_cdf"] = bound(*mesh_cost(st["samples"], st["vertex_floats"],
                                           st["nodes"], st["pairs"], d))
    if d == 3:
        evals = moving_evals(st)
        out["p2g_cdf"] = bound(*a_cost(ce, pg, nj, njg, nc, st["wv"], evals))
        out["g2p"] = bound(*g2p_cost(ce, pg, nj, njg, st["wv"], evals))
        out["update_rows"] = bound(*c_cost(C_ROWS_READ_3D, 12, 6, pchan, npad, ce, 6000))
    else:
        width = npad + st["group"] + 128
        out["pcdf2d"] = bound(*pcdf2d_cost(pg, njg, nc, width, npad))
        out["p2g2d"] = bound(*p2g2d_cost(ce, pg, nj, njg, nc))
        out["g2p2d"] = bound(*g2p2d_cost(ce, pg, nj, njg, width))
        out["update_rows"] = bound(*c_cost(C_ROWS_READ_2D, 6, 5, pchan, npad, ce, 400))
    return out
