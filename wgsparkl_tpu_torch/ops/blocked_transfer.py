"""The blocked transfer (port of wgsparkl_tpu/ops/blocked_transfer.py:
`p2g_blocked` and `g2p_blocked`, :52 and :168).

The JAX package's blocked path sorts the particles by home block, cuts the
sorted lanes into jobs of at most `group` particles (ops/blocked.build_jobs,
at most max_jobs of them) and runs P2G and G2P per job as one-hot matrix
products, a TPU work-around that the port does not carry.  What a user sees
of it is kept: the particles come back block-sorted, and the lanes of jobs
past max_jobs take no part: they give nothing to the grid or the impulses
and get zero velocity and gradient.  The live jobs cover the sorted lanes
[0, covered_end) in one run (blocks in key order, each block's jobs in
rank order), so the lane mask is the bound `live_end`, and the blocked
substep (pipeline._substep_dense) runs the dense kernels dense_p2g and
dense_g2p on the sorted rows with it.  `p2g_blocked` and `g2p_blocked`
take and give the JAX package's block-major node arrays [NB + 1, BS.., C]
(4^3 / 8^2 blocks, the ghost block NB) and run the same kernels, reading
them row-major through ops/blocked.block_major_index.
"""

from __future__ import annotations

import torch

from wgsparkl_tpu_torch.ops import blocked as bk
from wgsparkl_tpu_torch.ops import rows as R
from wgsparkl_tpu_torch.ops.kernel import inv_d


def live_end(jobs):
    """One-element int32: the end of the sorted lanes the live jobs cover
    (the blocked transfer's lane mask: lanes >= it take no part)."""
    live = jobs["len"] > 0
    return torch.max(torch.where(live, jobs["start"] + jobs["len"], 0)).to(
        torch.int32).reshape(1)


def _sorted_inputs(sp, bodies, grid_aff, grid_closest, cfg, nc: int):
    """(rows, particle-CDF rows, row-major node affinity and closest body,
    body table) of the sorted particle dict sp (pos, vel, mass, affine,
    aff, normal) and the block-major node arrays."""
    from wgsparkl_tpu_torch.ops.transfer import particle_cdf_rows, particle_rows

    node_aff = node_closest = None
    if nc > 0:
        node_aff = bk.from_blocks(grid_aff, cfg).reshape(-1).contiguous()
        node_closest = bk.from_blocks(grid_closest, cfg).reshape(-1).contiguous()
    return (particle_rows(sp["pos"], sp["vel"], sp["mass"], sp["affine"]),
            particle_cdf_rows(sp["aff"], sp["normal"]), node_aff, node_closest,
            R.body_table(bodies))


def p2g_blocked(sp, jobs, bodies, grid_aff, grid_closest, cfg, nc: int, group: int,
                chunk: int):
    """P2G of the block-sorted particles (sp: pos, vel, mass, affine, aff
    int32, normal) with the CPIC impulses: (grid_mm [NB + 1, BS.., d + 1]
    momentum and mass block-major, lin_imp [B, d], ang_imp [B, 3 or 1]).
    grid_aff / grid_closest: the node CDF block-major [NB + 1, BS.., 1]
    int32.  The lanes of the live jobs of `jobs` take part (live_end);
    group and chunk, the JAX package's job geometry, are not read (no job
    is run as a tile here).  Kernel dense_p2g on the card."""
    from wgsparkl_tpu_torch.ops.transfer import dense_p2g

    n = sp["pos"].shape[0]
    rows, pcdf, node_aff, node_closest, btable = _sorted_inputs(
        sp, bodies, grid_aff, grid_closest, cfg, nc)
    mm, lin, ang = dense_p2g(rows, pcdf, n, live_end(jobs), node_aff, node_closest,
                             btable, cfg, nc, bodies.count)
    return bk.to_blocks(mm, cfg), lin[:bodies.count], ang[:bodies.count]


def g2p_blocked(sp, jobs, bodies, grid_vel_blocks, grid_aff, grid_closest, cfg,
                nc: int, group: int, chunk: int, n_particles: int):
    """G2P to the block-sorted particles from the block-major grid velocities
    [NB + 1, BS.., d]: (new_vel [N, d], vel_grad [N, d, d]) in sorted
    order, zero on the lanes of no live job.  Kernel dense_g2p on the card
    (its moments centred on the particle: the gradient is D^-1 S)."""
    from wgsparkl_tpu_torch.ops.transfer import dense_g2p

    d = cfg.dim
    rows, pcdf, node_aff, node_closest, btable = _sorted_inputs(
        sp, bodies, grid_aff, grid_closest, cfg, nc)
    grid_vel = bk.from_blocks(grid_vel_blocks, cfg).contiguous()
    krows = dense_g2p(rows, pcdf, n_particles, live_end(jobs), grid_vel, node_aff,
                      node_closest, btable, cfg, nc)
    n = n_particles
    grad = inv_d(cfg.cell_width) * krows[d:d + d * d].T.reshape(n, d, d)
    return krows[:d].T.contiguous(), grad.contiguous()
