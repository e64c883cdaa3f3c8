"""The blocked transfer (port of wgsparkl_tpu/ops/blocked_transfer.py,
the semantics of `p2g_blocked` and `g2p_blocked`, :52 and :168).

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
dense_g2p on the sorted rows with it.
"""

from __future__ import annotations

import torch


def live_end(jobs):
    """One-element int32: the end of the sorted lanes the live jobs cover
    (the blocked transfer's lane mask: lanes >= it take no part)."""
    live = jobs["len"] > 0
    return torch.max(torch.where(live, jobs["start"] + jobs["len"], 0)).to(
        torch.int32).reshape(1)
