"""Per-pass timing harness (port of wgsparkl_tpu/utils/timing.py).

`time_passes` runs each pass of a dense-transfer substep on its own, on the
state's device, and reports milliseconds a call under the JAX package's
pass names: grid_update_cdf (`collision/cdf.node_cdf`, the analytic
colliders on the row-major grid), g2p_cdf (the particle CDF, kernel
dense_pcdf), p2g (`ops/transfer.p2g`, kernel dense_p2g), grid_update, g2p
(`ops/transfer.g2p`, kernel dense_g2p), particle_update
(`ops/particle_update.particle_update`, kernel C) and rigid_impulses (the
rigid update).  It times the dense transfer's functions whatever
cfg.transfer is, as the JAX package does.  On the card a
pass is timed with CUDA events around `iters` calls after one warm call; on
the CPU with the host clock.  `profile_trace` writes a torch.profiler
Chrome trace of one call.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict

import torch


@dataclasses.dataclass
class Timestamps:
    """Per-pass timings in ms."""

    passes: Dict[str, float]

    def total(self) -> float:
        return sum(self.passes.values())

    def report(self) -> str:
        lines = [f"{k:>24s}: {v:8.3f} ms" for k, v in self.passes.items()]
        lines.append(f"{'TOTAL':>24s}: {self.total():8.3f} ms")
        return "\n".join(lines)


def _ms_per_call(fn: Callable, iters: int, device: torch.device):
    """(the last output, ms a call) of fn over `iters` calls after a warm one."""
    out = fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return out, start.elapsed_time(end) / iters
    t = time.perf_counter()
    for _ in range(iters):
        out = fn()
    return out, (time.perf_counter() - t) / iters * 1e3


def time_passes(state, params, cfg, iters: int = 10) -> Timestamps:
    """Time each pass of a dense substep on `state` (a SimState) separately,
    through the struct-form functions the JAX package's harness times:
    collision/cdf.node_cdf, ops/transfer.p2g, grid_update, g2p and
    ops/particle_update.particle_update, each on the state as given."""
    from wgsparkl_tpu_torch import pipeline as P
    from wgsparkl_tpu_torch.collision.cdf import dense_pcdf, node_cdf
    from wgsparkl_tpu_torch.ops import rows as R
    from wgsparkl_tpu_torch.ops import rows2d as R2
    from wgsparkl_tpu_torch.ops import transfer
    from wgsparkl_tpu_torch.ops.particle_update import particle_update
    from wgsparkl_tpu_torch.rigid import body as body_mod
    from wgsparkl_tpu_torch.solver import attach_material_table

    grid = cfg.grid
    d, nc = grid.dim, cfg.num_colliders
    dev = state.particles.pos.device
    results: Dict[str, float] = {}

    def bench(name: str, fn: Callable):
        out, results[name] = _ms_per_call(fn, iters, dev)
        return out

    particles, models = state.particles, state.models
    if models.mat_table is None:
        models, _ = attach_material_table(particles, models, limit=None)
    bodies = body_mod.update_world_mass_properties(state.bodies)
    if nc > 0:
        node_pos = grid.node_positions(dev)
        node_dist, node_aff, node_closest = bench("grid_update_cdf", lambda: node_cdf(
            cfg.collider_types, bodies.shape_params, bodies.rot, bodies.pos, node_pos,
            grid.cell_width))
        rows = (R if d == 3 else R2).pack_rows_padded(particles, models, particles.count)
        bench("g2p_cdf", lambda: dense_pcdf(rows, particles.count, node_dist, node_aff,
                                            grid, nc))
    else:
        node_aff = torch.zeros(grid.num_nodes, dtype=torch.int32, device=dev)
        node_closest = torch.full_like(node_aff, -1)
    grid_mom, grid_mass, lin_imp, ang_imp = bench("p2g", lambda: transfer.p2g(
        particles, models, bodies, node_aff, node_closest, grid, nc))
    grid_mm = torch.cat([grid_mom, grid_mass[:, None]], dim=1)
    grid_vel = bench("grid_update", lambda: transfer.grid_update(grid_mm, params, grid))
    bench("g2p", lambda: transfer.g2p(particles, bodies, grid_vel, node_aff,
                                      node_closest, grid, nc))
    bench("particle_update", lambda: particle_update(particles, models, params, grid,
                                                     cfg.elastic_model))
    bench("rigid_impulses", lambda: P.rigid_bodies_update(bodies, lin_imp, ang_imp,
                                                          params, cfg))
    return Timestamps(passes=results)


def profile_trace(fn, args, log_dir: str | None = None) -> str:
    """A torch.profiler Chrome trace of one call of fn(*args), after a warm
    call, written to log_dir/trace.json (a new temporary directory by
    default); returns the file's path."""
    def call():
        out = fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return out

    call()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        call()
    log_dir = log_dir or tempfile.mkdtemp(prefix="wgsparkl_trace_")
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path
