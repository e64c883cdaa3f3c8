"""Simulation health diagnostics (port of wgsparkl_tpu/utils/diagnostics.py).

`check(data)` between frames reports, on the host, the capacities the
substeps mask on overflow: the job table's demand against max_jobs and, in
the sparse domain, the occupied blocks against kmax and the active slots
against amax; and the particles that left the grid or diverged.  The
on-device counterparts of the same conditions are the StepDiag a frame
returns (pipeline.step_with_diag).

The job demand is counted at the configuration's blocks (`cfg.by`).  The
JAX package counts it at 4 x 4 x 4 blocks whatever cfg.by is, so on a by-8
scene its count is larger than the job table's demand.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wgsparkl_tpu_torch.ops import blocked as bk


@dataclasses.dataclass
class HealthReport:
    num_particles: int
    jobs_needed: int          # job-table demand this instant
    max_jobs: int             # static capacity (0 = dense path, no limit)
    out_of_grid: int          # particles outside the grid / sparse key range
    non_finite: int           # particles with NaN/inf position or velocity
    max_speed: float
    max_def_grad: float
    # Sparse-domain capacities (0/0 on bounded configurations).
    occupied_blocks: int = 0
    kmax: int = 0
    active_blocks: int = 0
    amax: int = 0

    @property
    def job_overflow(self) -> bool:
        return self.max_jobs > 0 and self.jobs_needed > self.max_jobs

    @property
    def sparse_overflow(self) -> bool:
        return (self.kmax > 0 and self.occupied_blocks > self.kmax) or (
            self.amax > 0 and self.active_blocks > self.amax)

    @property
    def ok(self) -> bool:
        return not self.job_overflow and not self.sparse_overflow and self.non_finite == 0

    def summary(self) -> str:
        flags = []
        if self.job_overflow:
            flags.append(
                f"JOB OVERFLOW ({self.jobs_needed} > {self.max_jobs}): "
                "particles are being dropped from transfers — raise max_jobs")
        if self.kmax > 0 and self.occupied_blocks > self.kmax:
            flags.append(
                f"SPARSE BLOCK OVERFLOW ({self.occupied_blocks} > kmax="
                f"{self.kmax}): truncated blocks' particles are frozen — raise kmax")
        if self.amax > 0 and self.active_blocks > self.amax:
            flags.append(
                f"SPARSE ACTIVE-SLOT OVERFLOW ({self.active_blocks} > amax="
                f"{self.amax}): halo nodes are dropped — raise amax")
        if self.non_finite:
            flags.append(f"{self.non_finite} non-finite particles (diverged)")
        if self.out_of_grid:
            flags.append(f"{self.out_of_grid} particles out of grid bounds")
        status = "OK" if self.ok else "UNHEALTHY"
        detail = (f"N={self.num_particles} jobs={self.jobs_needed}/{self.max_jobs} "
                  f"|v|max={self.max_speed:.3g} |F|max={self.max_def_grad:.3g}")
        return f"{status}: {detail}" + ("; " + "; ".join(flags) if flags else "")


def _jobs(counts, group: int) -> int:
    return int(((counts + group - 1) // group).sum())


def check(data) -> HealthReport:
    """Health report of an MpmData's current state (reductions on the
    state's device, a few scalars back to the host)."""
    p, cfg = data.state.particles, data.config
    grid = cfg.grid
    pch = [p.pos[:, a] for a in range(p.dim)]
    occupied_blocks = active_blocks = 0
    if cfg.sparse:
        # No grid box: out of range is past the packed keys' reach.
        keys = bk.particle_sparse_keys_ch(pch, grid)
        live = keys < bk.SPARSE_SENTINEL
        out_of_grid = int((~live).sum())
        occ, counts = torch.unique(keys[live].to(torch.int64), return_counts=True)
        occupied_blocks = occ.numel()
        deltas = torch.tensor(bk.sparse_octant_deltas(), device=occ.device)
        active_blocks = torch.unique(occ[None, :] + deltas[:, None]).numel()
        jobs_needed = _jobs(counts, cfg.group)
    else:
        nb_total = int(np.prod(bk.num_blocks(grid, cfg.by)))
        ids = bk.particle_sort_keys_ch(pch, grid, cfg.by).to(torch.int64)
        out_of_grid = int((ids == nb_total).sum())
        jobs_needed = 0
        if cfg.max_jobs > 0:
            counts = torch.bincount(ids[ids < nb_total], minlength=nb_total)
            jobs_needed = _jobs(counts[counts > 0], cfg.group)
    good = torch.isfinite(p.pos).all(1) & torch.isfinite(p.vel).all(1)
    any_good = bool(good.any())
    return HealthReport(
        num_particles=p.count,
        jobs_needed=jobs_needed,
        max_jobs=cfg.max_jobs,
        out_of_grid=out_of_grid,
        non_finite=int((~good).sum()),
        max_speed=(float(torch.linalg.vector_norm(p.vel[good], dim=1).max())
                   if any_good else float("nan")),
        max_def_grad=(float(p.def_grad[good].abs().max()) if any_good
                      else float("nan")),
        occupied_blocks=occupied_blocks,
        kmax=cfg.kmax if cfg.sparse else 0,
        active_blocks=active_blocks,
        amax=cfg.amax if cfg.sparse else 0,
    )
