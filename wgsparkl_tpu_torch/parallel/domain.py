"""Multi-device stepping on torch.distributed (port of
wgsparkl_tpu/parallel/domain.py).

Two modes, as in the JAX package:

  * particle-sharded (`shard_state`, `make_sharded_step`): every rank holds
    a slice of the particles and the whole local grid; each substep the
    grid (momentum and mass) and the rigid impulses are summed over ranks
    after P2G (`Comm.psum`), and G2P and the particle update stay local.
    The dense, blocked and pallas transfers, 3D and 2D.  The sparse domain
    is refused here: each rank's slot table holds other blocks, so a sum
    of slot grids adds unrelated blocks (the JAX package sums them).
  * spatial (`spatial_config`, `shard_state_spatial`): the pallas path's
    grid is split into x-block slabs, one a rank.  Each substep a rank
    migrates the particles that left its slab to its neighbours through
    buffers of migration_cap lanes a side and sorts a second time; after
    P2G it exchanges one boundary block-plane (bounded grid) or the
    boundary plane's active (key, row) pairs, at most halo_cap (sparse
    domain), instead of summing the grid (pipeline._migrate_x,
    _halo_exchange_x, _halo_exchange_sparse).  The sparse domain's slabs
    split the nominal grid's x extent; the edge ranks own everything
    beyond it.

The JAX package places one global array over a device mesh; the port keeps
one process a rank, each with its own shard and device (`launch.run`), and
its own `Comm`.  `map_state` and `gather_state` are port-only: a shard's
leaves as numpy arrays for the trip between processes, and the ranks'
shards joined in rank order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wgsparkl_tpu_torch.ops import blocked as bk
from wgsparkl_tpu_torch.pipeline import (
    MpmConfig, SimState, StepDiag, step_dense, step_pallas,
)


def _map_obj(fn, obj):
    if obj is None:
        return None
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, dict):
            v = {k: fn(x) for k, x in v.items()}
        elif v is not None:
            v = fn(v)
        kw[f.name] = v
    return dataclasses.replace(obj, **kw)


def map_state(fn, state: SimState) -> SimState:
    """state with fn applied to every array leaf (particles, models, bodies,
    meshes), e.g. `lambda t: t.cpu().numpy()` and back `torch.as_tensor`."""
    return SimState(particles=_map_obj(fn, state.particles),
                    models=_map_obj(fn, state.models),
                    bodies=_map_obj(fn, state.bodies),
                    meshes=_map_obj(fn, state.meshes))


def _map_particle_leaves(fn, state: SimState) -> SimState:
    """fn on the particle-indexed leaves (every particle and model field but
    the material table); bodies, meshes and the table stay."""
    mtab = state.models.mat_table
    models = _map_obj(fn, dataclasses.replace(state.models, mat_table=None))
    return SimState(particles=_map_obj(fn, state.particles),
                    models=dataclasses.replace(models, mat_table=mtab),
                    bodies=state.bodies, meshes=state.meshes)


def pad_particle_count(n: int, n_devices: int) -> int:
    return ((n + n_devices - 1) // n_devices) * n_devices


def pad_state(state: SimState, grid, n_total: int) -> SimState:
    """state with zero-mass lanes appended up to n_total particles (port-
    only; `pad_particle_count` gives the count): F = I, no velocity, id -1,
    the models of particle 0, placed eight cells below the grid's origin,
    where no job takes them and kernel C keeps their rows."""
    p = state.particles
    k = n_total - p.count
    if k < 0:
        raise ValueError(f"{p.count} particles exceed {n_total}")
    if k == 0:
        return state
    d = p.dim

    def tail(x, fill=None):
        t = x[:1].expand((k,) + tuple(x.shape[1:])).clone()
        if fill is not None:
            t.fill_(fill)
        return torch.cat([x, t])

    corner = torch.tensor([(o - 8) * grid.cell_width for o in grid.origin_cell],
                          dtype=p.pos.dtype, device=p.pos.device)
    particles = dataclasses.replace(
        p, pos=torch.cat([p.pos, corner.expand(k, d)]), vel=tail(p.vel, 0.0),
        def_grad=torch.cat([p.def_grad, torch.eye(d, device=p.pos.device)
                            .expand(k, d, d)]),
        affine=tail(p.affine, 0.0), init_volume=tail(p.init_volume, 0.0),
        init_radius=tail(p.init_radius), mass=tail(p.mass, 0.0),
        cdf_normal=tail(p.cdf_normal, 0.0), cdf_rigid_vel=tail(p.cdf_rigid_vel, 0.0),
        cdf_signed_distance=tail(p.cdf_signed_distance, 0.0),
        cdf_affinity=tail(p.cdf_affinity, 0), ids=tail(p.ids, -1))
    models = _map_particle_leaves(tail, SimState(None, state.models, None)).models
    return dataclasses.replace(state, particles=particles, models=models)


def shard_state(state: SimState, rank: int, world: int) -> SimState:
    """This rank's slice of the particles (and their models) of a state whose
    particle count divides over the ranks; bodies, meshes and the material
    table replicated (the JAX package's state_specs layout)."""
    n = state.particles.count
    if n % world:
        raise ValueError(f"{n} particles do not divide over {world} ranks "
                         "(pad_state to pad_particle_count first)")
    m = n // world
    return _map_particle_leaves(lambda x: x[rank * m:(rank + 1) * m], state)


def gather_state(shards) -> SimState:
    """The ranks' shards (torch or numpy leaves) joined in rank order; bodies
    and meshes of the first."""
    def cat(*xs):
        return np.concatenate(xs) if isinstance(xs[0], np.ndarray) else torch.cat(xs)

    first = shards[0]
    parts = [_map_particle_leaves(lambda x: [x], s) for s in shards]

    def join(objs):
        out = {}
        for f in dataclasses.fields(objs[0]):
            vals = [getattr(o, f.name) for o in objs]
            if isinstance(vals[0], dict):
                out[f.name] = {k: cat(*(v[k][0] for v in vals)) for k in vals[0]}
            elif isinstance(vals[0], list):
                out[f.name] = cat(*(v[0] for v in vals))
            else:
                out[f.name] = vals[0]
        return dataclasses.replace(objs[0], **out)

    return SimState(particles=join([s.particles for s in parts]),
                    models=join([s.models for s in parts]),
                    bodies=first.bodies, meshes=first.meshes)


def make_sharded_step(cfg: MpmConfig, comm, num_substeps: int,
                      with_diag: bool = False):
    """(state, params) -> state: num_substeps substeps of this rank's shard
    on cfg.transfer's path, summing (or, under spatial_config, exchanging)
    with the other ranks of comm every substep.  with_diag: also the
    frame's StepDiag, each counter a [world] vector of the ranks' values
    (zero on the dense and blocked paths, which keep no counter)."""
    if cfg.spatial_devices and cfg.spatial_devices != comm.world:
        raise ValueError(f"the configuration has {cfg.spatial_devices} slabs for "
                         f"{comm.world} ranks")
    if cfg.sparse and not cfg.spatial_devices:
        raise ValueError("the sparse domain shards spatially (spatial_config): "
                         "the ranks' slot tables differ, so their grids cannot "
                         "be summed")

    def step(state, params):
        if cfg.transfer == "pallas":
            state, diag = step_pallas(state, params, cfg, num_substeps,
                                      return_diag=True, comm=comm)
        else:
            state = step_dense(state, params, cfg, num_substeps, comm=comm)
            diag = StepDiag.zeros(state.particles.pos.device)
        if not with_diag:
            return state
        return state, StepDiag(*(comm.gather(getattr(diag, f.name))
                                 for f in dataclasses.fields(diag)))

    return step


def spatial_config(cfg: MpmConfig, n_devices: int, migration_cap: int = 2048,
                   halo_cap: int = 1024) -> MpmConfig:
    """cfg for the spatial x-slab decomposition over n_devices ranks (pallas
    path, bounded grid or sparse domain), whose x block count must divide
    over them."""
    if cfg.transfer != "pallas":
        raise ValueError("spatial slabs run on the pallas transfer")
    nb = bk.num_blocks(cfg.grid)
    if nb[0] % n_devices:
        raise ValueError(f"x block count {nb[0]} must divide over {n_devices} devices")
    return dataclasses.replace(cfg, spatial_devices=n_devices,
                               migration_cap=migration_cap, halo_cap=halo_cap)


def shard_state_spatial(state: SimState, cfg: MpmConfig, rank: int,
                        slack: float = 0.5) -> SimState:
    """This rank's x-slab chunk: the particles whose home block lies in its
    slab (the edge slabs take everything beyond), padded with dead lanes
    (mass 0, F = I, id -1, every other field 0) to the common capacity, the
    largest slab's count with `slack` headroom for migration, rounded up to
    8.  Bodies, meshes and the material table replicated."""
    world = cfg.spatial_devices
    dim = state.particles.dim
    wx = bk.num_blocks(cfg.grid)[0] // world
    bs = bk.block_shape(dim)[0]
    pos = state.particles.pos.cpu().numpy()
    bx = (np.round(pos[:, 0] / cfg.grid.cell_width).astype(np.int64) - 1
          - int(cfg.grid.origin_cell[0])) // bs
    slab = np.clip(bx // wx, 0, world - 1)
    order = np.argsort(slab, kind="stable")
    counts = np.bincount(slab, minlength=world)
    cap = int(np.ceil(counts.max() * (1.0 + slack)))
    cap = -(-cap // 8) * 8
    start = int(counts[:rank].sum())
    sel = torch.as_tensor(order[start:start + counts[rank]],
                          device=state.particles.pos.device)

    def chunk(x):
        out = torch.zeros((cap,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        out[:len(sel)] = x[sel]
        return out

    out = _map_particle_leaves(chunk, state)
    p = out.particles
    dead = p.mass == 0.0
    p.def_grad[dead] = torch.eye(dim, dtype=p.def_grad.dtype, device=p.def_grad.device)
    p.ids[dead] = -1
    return out
