"""Per-pass timing harness (port of wgsparkl_tpu/utils/timing.py).

`time_passes` runs each pass of a dense-transfer substep on its own, on the
state's device, and reports milliseconds a call under the JAX package's
pass names: grid_update_cdf (every collider's node CDF on the row-major
grid), g2p_cdf (the particle CDF, kernel dense_pcdf), p2g (kernel
dense_p2g), grid_update, g2p (kernel dense_g2p), particle_update (kernel
C) and rigid_impulses (the rigid update).  It times the dense transfer's
functions whatever cfg.transfer is, as the JAX package does.  On the card a
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
    """Time each pass of a dense substep on `state` (a SimState) separately."""
    from wgsparkl_tpu_torch import pipeline as P
    from wgsparkl_tpu_torch.collision.cdf import dense_pcdf
    from wgsparkl_tpu_torch.ops import rows as R
    from wgsparkl_tpu_torch.ops import rows2d as R2
    from wgsparkl_tpu_torch.ops.transfer import dense_g2p, dense_p2g, grid_update
    from wgsparkl_tpu_torch.ops.update_rows import update_rows, update_rows2d
    from wgsparkl_tpu_torch.rigid import body as body_mod
    from wgsparkl_tpu_torch.solver import attach_material_table

    grid = cfg.grid
    d, nc = grid.dim, cfg.num_colliders
    dev = state.particles.pos.device
    results: Dict[str, float] = {}

    def bench(name: str, fn: Callable):
        out, results[name] = _ms_per_call(fn, iters, dev)
        return out

    models, n_mat = state.models, max(cfg.n_materials, 1)
    if models.mat_table is None:
        models, n_mat = attach_material_table(state.particles, models, limit=None)
    n = state.particles.count
    npad = P.pallas_npad(n, cfg.group)
    rows = (R if d == 3 else R2).pack_rows_padded(state.particles, models, npad)
    n_t = torch.full((1,), n, dtype=torch.int32, device=dev)
    zero_ids = torch.zeros(npad, dtype=torch.int32, device=dev)
    bodies = body_mod.update_world_mass_properties(state.bodies)
    btable = (P._body_table if d == 3 else P._body_table_2d)(bodies, params, grid)
    node_aff = node_closest = None
    if nc > 0:
        node_dist, node_aff, node_closest = bench(
            "grid_update_cdf", lambda: P._dense_node_cdf(bodies, cfg, state.meshes))
        pcdf = bench("g2p_cdf", lambda: dense_pcdf(rows, n, node_dist, node_aff, grid,
                                                   nc))
    else:
        pcdf = P._cdf_rows(rows, d)
    grid_mm, lin_imp, ang_imp = bench("p2g", lambda: dense_p2g(
        rows, pcdf, n, n_t, node_aff, node_closest, btable, grid, nc, bodies.count))
    grid_vel = bench("grid_update", lambda: grid_update(grid_mm, params, grid))
    krows = bench("g2p", lambda: dense_g2p(rows, pcdf, n, n_t, grid_vel, node_aff,
                                           node_closest, btable, grid, nc))
    update = update_rows if d == 3 else update_rows2d
    bench("particle_update", lambda: update(
        rows, krows, pcdf, zero_ids, n_t, btable, models.mat_table, params.dt,
        grid.cell_width, nc, n_mat, 1, cfg.elastic_model, centered=True))
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
