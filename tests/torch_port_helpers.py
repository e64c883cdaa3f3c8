"""Shared set-up for the tests that hold the PyTorch port against the JAX
package: scenes built in both packages from the same arrays, and one
substep of the JAX main path taken apart phase by phase so that each of the
port's kernels can be fed the reference phase's own inputs; `run_both`
steps a JAX scene in both packages."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from wgsparkl_tpu import scenes
from wgsparkl_tpu.pipeline import MpmData
from wgsparkl_tpu.pipeline import step_pallas as jax_step_pallas
from wgsparkl_tpu_torch.scenes import spin_velocities

BY = 8
GROUP = 256


def to_torch(x):
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(np.array(a))


def jax_scene(shift=(0.0, 0.0, 0.0), fold_vel: bool = False) -> MpmData:
    """sand_box_3d(nxz=8, ny=16) with the paddle on the bounded pallas path
    (by=8, group=256); `shift` moves the particle lattice (the grid and the
    colliders stay), e.g. onto the floor away from the paddle; fold_vel:
    the grid update folded into G2P."""
    d3 = scenes.sand_box_3d(nxz=8, ny=16, cell_width=1.0, with_paddle=True)
    p = d3.state.particles
    if any(shift):
        p = p.replace(pos=p.pos + jnp.asarray(shift, jnp.float32))
    return MpmData(d3.params, p, d3.state.models, d3.bodies_desc, 1.0,
                   grid=d3.config.grid, transfer="pallas", group=GROUP,
                   job_chunk=8, by=BY, fold_vel=fold_vel)


# Lattice placements: as built (jobs near the paddle at gate level 2, the
# top layers at level 0); moved onto the floor 12 cells from the paddle
# (jobs near the floor see only static colliders: level 1); lowered onto
# the paddle (incompatible pairs, so nonzero CPIC impulses).
SHIFTS = {
    "as_built": (0.0, 0.0, 0.0),
    "on_floor": (12.0, -4.5, 0.0),
    "on_paddle": (0.0, -3.0, 0.0),
}


def _phases(rows_all, bodies, params, cfg, n, static_chan, mtable):
    """One JAX 3D substep (gathered hybrid, or chan-free when cfg.chan_free;
    the grid update folded into G2P when cfg.fold_vel), returning every
    phase's arrays."""
    from wgsparkl_tpu.ops import blocked as bk
    from wgsparkl_tpu.ops import pallas_transfer as ptf
    from wgsparkl_tpu.ops.kernel import inv_d
    from wgsparkl_tpu.ops.permute import permute_lanes
    from wgsparkl_tpu.ops.update_rows import update_rows
    from wgsparkl_tpu.pipeline import (
        StepDiag, _body_table, _bounded_job_phase, _cdf_kernel_phase_3d,
        _grid_velocity, _moving_reach_gate, rigid_bodies_update)
    from wgsparkl_tpu.rigid import body as body_mod

    grid, by, group, nc = cfg.grid, cfg.by, cfg.group, cfg.num_colliders
    npad = rows_all.shape[1]
    wsh, _, wpad = ptf.window_geom(by)
    nb_total = int(np.prod(bk.num_blocks(grid, by)))
    bodies = body_mod.update_world_mass_properties(bodies)
    lane = jnp.arange(npad, dtype=jnp.int32)
    keys = bk.particle_sort_keys_ch([rows_all[0], rows_all[1], rows_all[2]],
                                    grid, by)
    keys = jnp.where(lane < n, keys, nb_total + 1)
    sids, perm = jax.lax.sort((keys, lane), num_keys=1)
    rows = permute_lanes(rows_all, perm)
    jobs, bcells, covered_end, gather_tiles, scatter_mm, _, _ = (
        _bounded_job_phase(sids, grid, 3, by, group, cfg, npad,
                           StepDiag.zeros()))
    static_desc = tuple((i, cfg.collider_types[i]) for i in range(nc)
                        if i in cfg.static_slots)
    moving = tuple((i, cfg.collider_types[i]) for i in range(nc)
                   if i not in cfg.static_slots)
    gate = (None if cfg.chan_free
            else _moving_reach_gate(bcells, bodies, moving, wsh, grid.cell_width))
    btable = _body_table(bodies, params, grid)
    ntiles, jbody, mm, imp, pcdf, pdata = _cdf_kernel_phase_3d(
        rows[:ptf.NCHAN], static_chan, gather_tiles, btable, jobs, bcells, grid,
        group, npad, nc, by=by, static_slots=cfg.static_slots, bodies=bodies,
        mode=(cfg.chan_free, static_desc, moving), moving_gate=gate)
    grid_mm = jnp.zeros((nb_total + 1,) + bk.block_shape(3, by) + (4,),
                        jnp.float32)
    grid_mm = scatter_mm(grid_mm, mm)
    if not cfg.fold_vel:
        grid_mm = grid_mm.at[..., :3].set(_grid_velocity(grid_mm, params, grid, 3))
    ftiles = gather_tiles(grid_mm, out=(wpad, 4))
    krows = ptf.g2p_rows(pdata, ftiles, ntiles, btable, jobs, bcells, grid,
                         group, npad, nc, jbody, by=by, moving=moving,
                         static_desc=static_desc, chan_free=cfg.chan_free,
                         fold_vel=cfg.fold_vel)
    rows_out = update_rows(rows, krows, pcdf, sids, covered_end, btable, mtable,
                           params, cfg, nc, inv_d(grid.cell_width),
                           live_below=nb_total)
    lin = imp[0, 0:3, :bodies.count].T
    ang = imp[0, 3:6, :bodies.count].T
    new_bodies = rigid_bodies_update(bodies, lin, ang, params, cfg)
    out = dict(unsorted=rows_all, perm=perm, rows=rows, sorted_ids=sids,
               start=jobs["start"], len=jobs["len"], block=jobs["block"],
               bcells=bcells, covered_end=covered_end, ntiles=ntiles,
               jbody=jbody, btable=btable, mm=mm, imp=imp, pcdf=pcdf,
               pdata=pdata, grid_mm=grid_mm, ftiles=ftiles, krows=krows,
               rows_out=rows_out)
    return rows_out, new_bodies, out


@functools.lru_cache(maxsize=None)
def jax_dump(shift=(0.0, 0.0, 0.0), substeps_before: int = 2,
             fold_vel: bool = False):
    """(MpmData, dict of numpy arrays) of the JAX main path's phases in the
    substep after `substeps_before` substeps of the scene."""
    return dump_phases(jax_scene(shift, fold_vel), substeps_before)


def dump_phases(data: MpmData, substeps_before: int = 2):
    """(data, dict of numpy arrays) of the phases of a 3D scene with a
    static collider (gathered hybrid or chan-free mode) in the substep
    after `substeps_before` substeps."""
    from wgsparkl_tpu.ops import blocked as bk
    from wgsparkl_tpu.ops import pallas_transfer as ptf
    from wgsparkl_tpu.pipeline import _cdf_chan_grid, _node_cdf_static, pallas_npad

    cfg, st = data.config, data.state
    n = st.particles.count
    npad = pallas_npad(n, cfg.group)
    rows = ptf.pack_rows_padded(st.particles, st.models, npad)
    nb_total = int(np.prod(bk.num_blocks(cfg.grid, cfg.by)))
    static_chan = _cdf_chan_grid(*_node_cdf_static(st.bodies, cfg,
                                                   block_major=True),
                                 nb_total, 3, cfg.by)
    fn = jax.jit(_phases, static_argnums=(3, 4))
    bodies = st.bodies
    for _ in range(substeps_before + 1):
        rows, bodies, out = fn(rows, bodies, data.params, cfg, n, static_chan,
                               st.models.mat_table)
    out = {k: np.asarray(v) for k, v in out.items()}
    out["static_chan"] = np.asarray(static_chan)
    out["mtable"] = np.asarray(st.models.mat_table)
    return data, out


def port_jobs(d):
    """The dump's job table as the port's tensors."""
    jobs = {k: to_torch(d[k]) for k in ("start", "len", "block")}
    return jobs, to_torch(d["bcells"]).to(torch.int32), to_torch(d["jbody"])


def moving_of(cfg):
    return tuple((i, t) for i, t in enumerate(cfg.collider_types)
                 if i not in cfg.static_slots)


def static_of(cfg):
    return tuple((i, t) for i, t in enumerate(cfg.collider_types)
                 if i in cfg.static_slots)


def compare_states(ref, out, colliders: bool = True):
    """Particles by identity: the precedent tolerances of
    test_pallas_transfer.py's path-vs-path comparisons.  With colliders the
    affinity words must be nonzero near them; a collider-free scene's must
    all stay zero, and its inert body slot exactly equal."""
    ij = np.argsort(np.asarray(ref.particles.ids))
    it = np.argsort(out.particles.ids.numpy())
    rp, tp = ref.particles, out.particles
    np.testing.assert_allclose(tp.pos.numpy()[it], np.asarray(rp.pos)[ij],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp.vel.numpy()[it], np.asarray(rp.vel)[ij],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(tp.def_grad.numpy()[it],
                               np.asarray(rp.def_grad)[ij], rtol=0, atol=1e-4)
    aff = np.asarray(rp.cdf_affinity)[ij]
    np.testing.assert_array_equal(tp.cdf_affinity.numpy().view(np.uint32)[it], aff)
    assert (aff != 0).sum() > 20 if colliders else not aff.any()
    for f in ("pos", "rot", "linvel", "angvel"):
        np.testing.assert_allclose(getattr(out.bodies, f).numpy(),
                                   np.asarray(getattr(ref.bodies, f)),
                                   rtol=0, atol=1e-6 if colliders else 0.0)


# ------------------------------------------------------------------- 2D
GROUP_2D = 128
SCENES_2D = ("sand_column", "elastic_blocks")
# Lattice placements of the 2D scenes: as built, and lowered 1.5 cells into
# the floor (incompatible pairs in gated jobs, so nonzero CPIC impulses).
SHIFTS_2D = {"as_built": 0.0, "in_floor": -0.75}


def jax_scene_2d(kind: str, shift: float = 0.0, chan_free: bool = False,
                 fold_vel: bool = False) -> MpmData:
    """sand_column_2d(nx=24, ny=48) or elastic_blocks_2d(n_side=24) at cell
    width 0.5 on the bounded pallas path (group 128); `shift` moves the
    particle lattice in y (the grid and the colliders stay); chan_free and
    fold_vel: the CDF mode and the grid update folded into G2P."""
    build = {"sand_column": lambda **kw: scenes.sand_column_2d(nx=24, ny=48, **kw),
             "elastic_blocks": lambda **kw: scenes.elastic_blocks_2d(n_side=24, **kw)}
    d2 = build[kind](cell_width=0.5, transfer="pallas", group=GROUP_2D)
    if not (shift or chan_free or fold_vel):
        return d2
    p = d2.state.particles
    p = p.replace(pos=p.pos + jnp.asarray([0.0, shift], jnp.float32))
    return MpmData(d2.params, p, d2.state.models, d2.bodies_desc, 0.5,
                   grid=d2.config.grid, transfer="pallas", group=GROUP_2D,
                   chan_free=chan_free, fold_vel=fold_vel)


def _phases_2d(rows_all, bodies, params, cfg, n, static_chan, mtable):
    """One JAX 2D substep (the gathered all-static branch of
    _substep_pallas_rows_2d, or its chan-free branch when cfg.chan_free;
    the grid update folded into G2P when cfg.fold_vel), returning every
    phase's arrays."""
    from wgsparkl_tpu.ops import blocked as bk
    from wgsparkl_tpu.ops import pallas_transfer2d as ptf
    from wgsparkl_tpu.ops.kernel import inv_d
    from wgsparkl_tpu.ops.permute import permute_lanes
    from wgsparkl_tpu.ops.update_rows import update_rows
    from wgsparkl_tpu.pipeline import (
        StepDiag, _bounded_job_phase, _cdf_mode, _grid_velocity, _jbody_gate,
        _moving_reach_gate, _split_impulses, rigid_bodies_update)
    from wgsparkl_tpu.rigid import body as body_mod

    grid, group, nc = cfg.grid, cfg.group, cfg.num_colliders
    npad = rows_all.shape[1]
    nb_total = int(np.prod(bk.num_blocks(grid)))
    bodies = body_mod.update_world_mass_properties(bodies)
    lane = jnp.arange(npad, dtype=jnp.int32)
    keys = bk.particle_sort_keys_ch([rows_all[0], rows_all[1]], grid)
    keys = jnp.where(lane < n, keys, nb_total + 1)
    sids, perm = jax.lax.sort((keys, lane), num_keys=1)
    rows = permute_lanes(rows_all, perm)
    jobs, bcells, covered_end, gather_tiles, scatter_mm, _, _ = (
        _bounded_job_phase(sids, grid, 2, 4, group, cfg, npad,
                           StepDiag.zeros()))
    mode = _cdf_mode(cfg)
    alldesc = tuple(sorted(mode[1] + mode[2]))
    btable = jnp.zeros((16, 128), jnp.float32)
    btable = btable.at[0:2, :bodies.count].set(bodies.world_com.T)
    btable = btable.at[2:4, :bodies.count].set(bodies.linvel.T)
    btable = btable.at[4:5, :bodies.count].set(bodies.angvel.T)
    btable = btable.at[5:7, :bodies.count].set(bodies.rot.T)
    btable = btable.at[7:9, :bodies.count].set(bodies.pos.T)
    btable = btable.at[9:12, :bodies.count].set(bodies.shape_params[:, :3].T)
    btable = btable.at[13, :2].set(params.gravity * params.dt)
    btable = btable.at[13, 2].set(grid.cell_width / params.dt)
    chan_free = cfg.chan_free
    if chan_free:
        jbody = _moving_reach_gate(bcells, bodies, alldesc, (10, 10),
                                   grid.cell_width).astype(jnp.int32)
        ntiles = jnp.zeros((1, ptf.WPAD, 4), jnp.float32)
    else:
        ntiles = gather_tiles(static_chan, out=(ptf.WPAD, 4), c=4)
        jbody = _jbody_gate(ntiles, ptf.WVOL)
    pdata0 = rows[:ptf.NCHAN]
    pcdf = ptf.pcdf_rows(pdata0, ntiles, btable, jobs, bcells, grid, group,
                         npad, nc, jbody, alldesc=alldesc, chan_free=chan_free)
    pdata = jax.lax.dynamic_update_slice(
        pdata0, jnp.concatenate([pcdf[0:1, :npad], pcdf[2:4, :npad],
                                 pcdf[4:5, :npad]], axis=0), (ptf.AFF, 0))
    itiles = (jnp.zeros((1, ptf.WPAD, 2), jnp.int32) if chan_free else
              jnp.stack([(ntiles[..., 1].astype(jnp.int32) << 16)
                         | ntiles[..., 0].astype(jnp.int32),
                         ntiles[..., 2].astype(jnp.int32)], axis=-1))
    mm, imp = ptf.p2g_tiles(pdata, itiles, btable, jobs, bcells, grid, group,
                            nc, jbody, alldesc=alldesc, chan_free=chan_free)
    grid_mm = jnp.zeros((nb_total + 1, 8, 8, 3), jnp.float32)
    grid_mm = scatter_mm(grid_mm, mm)
    lin, ang = _split_impulses(imp, bodies.count, 2)
    if not cfg.fold_vel:
        grid_mm = grid_mm.at[..., :2].set(_grid_velocity(grid_mm, params, grid, 2))
    ftiles = gather_tiles(grid_mm, out=(ptf.WPAD, 4))
    krows = ptf.g2p_rows(pdata, ftiles, itiles, btable, jobs, bcells, grid,
                         group, npad, nc, jbody, alldesc=alldesc,
                         chan_free=chan_free, fold_vel=cfg.fold_vel)
    rows_out = update_rows(rows, krows, pcdf, sids, covered_end, btable, mtable,
                           params, cfg, nc, inv_d(grid.cell_width),
                           live_below=nb_total, dim=2)
    new_bodies = rigid_bodies_update(bodies, lin, ang, params, cfg)
    out = dict(unsorted=rows_all, perm=perm, rows=rows, sorted_ids=sids,
               start=jobs["start"], len=jobs["len"], block=jobs["block"],
               bcells=bcells, covered_end=covered_end, ntiles=ntiles,
               jbody=jbody, btable=btable, mm=mm, imp=imp, pcdf=pcdf,
               pdata=pdata, grid_mm=grid_mm, ftiles=ftiles, krows=krows,
               rows_out=rows_out)
    return rows_out, new_bodies, out


@functools.lru_cache(maxsize=None)
def jax_dump_2d(kind: str, shift: float = 0.0, substeps_before: int = 2,
                fold_vel: bool = False):
    """(MpmData, dict of numpy arrays) of the JAX 2D path's phases in the
    substep after `substeps_before` substeps of the scene."""
    return dump_phases_2d(jax_scene_2d(kind, shift, fold_vel=fold_vel),
                          substeps_before)


def dump_phases_2d(data: MpmData, substeps_before: int = 2):
    """(data, dict of numpy arrays) of the phases of a 2D scene whose
    colliders are all static, or of any 2D scene in the chan-free mode, in
    the substep after `substeps_before` substeps."""
    from wgsparkl_tpu.ops import blocked as bk
    from wgsparkl_tpu.ops import pallas_transfer2d as ptf
    from wgsparkl_tpu.pipeline import _cdf_chan_grid, _node_cdf_static, pallas_npad

    cfg, st = data.config, data.state
    n = st.particles.count
    npad = pallas_npad(n, cfg.group)
    rows = ptf.pack_rows_padded(st.particles, st.models, npad)
    nb_total = int(np.prod(bk.num_blocks(cfg.grid)))
    static_chan = _cdf_chan_grid(*_node_cdf_static(st.bodies, cfg,
                                                   block_major=True),
                                 nb_total, 2)
    fn = jax.jit(_phases_2d, static_argnums=(3, 4))
    bodies = st.bodies
    for _ in range(substeps_before + 1):
        rows, bodies, out = fn(rows, bodies, data.params, cfg, n, static_chan,
                               st.models.mat_table)
    out = {k: np.asarray(v) for k, v in out.items()}
    out["static_chan"] = np.asarray(static_chan)
    out["mtable"] = np.asarray(st.models.mat_table)
    return data, out


# ------------------------------------------------------- no collider
def jax_scene_free(dim: int, elastic: bool = False) -> MpmData:
    """The collider-free test scenes: the sand_box_3d(nxz=8, ny=16) lattice
    at by=8, group=256 (dim 3) or the sand_column_2d(nx=24, ny=48, cell
    width 0.5) lattice at group=128 (dim 2), with no bodies, spinning
    (the port's scenes.spin_velocities, jitter 0.5 m/s).  elastic:
    elastic_blocks_2d's models (E = 5e6, nu = 0.2, phase 1, no fracture)
    in place of the Drucker-Prager sand."""
    if dim == 3:
        d = scenes.sand_box_3d(nxz=8, ny=16, cell_width=1.0, with_paddle=False)
        h, kw = 1.0, dict(group=GROUP, job_chunk=8, by=BY)
    else:
        d = scenes.sand_column_2d(nx=24, ny=48, cell_width=0.5,
                                  transfer="pallas", group=GROUP_2D)
        h, kw = 0.5, dict(group=GROUP_2D)
    p, models = d.state.particles, d.state.models
    p = p.replace(vel=jnp.asarray(spin_velocities(p.pos, jitter=0.5)))
    if elastic:
        from wgsparkl_tpu.models.elasticity import ElasticCoefficients
        from wgsparkl_tpu.solver import Models

        e = ElasticCoefficients.from_young_modulus(5.0e6, 0.2)
        models = Models.from_arrays(p.count, e.lam, e.mu, phase=1.0,
                                    max_stretch=-1.0)
    return MpmData(d.params, p, models, [], h, grid=d.config.grid,
                   transfer="pallas", **kw)


# ------------------------------------------------------- analytic shapes
# Lattice placements of the shapes scene, each 2 cells above the halfspace
# floor: lowered onto the capsule paddle, moved onto the ball, and moved
# aside (x in [-13, -9]) out of both moving colliders' reach, where jobs
# see only the floor (gate level 1).
SHIFTS_SHAPES = {
    "on_capsule": (0.0, -3.0, 0.0),
    "on_ball": (8.0, -3.0, 8.0),
    "aside": (-11.0, -3.0, 0.0),
}


def shapes_bodies(walls):
    """The analytic-shapes scene's bodies (JAX package): a static halfspace
    at the origin (the sand box floor's top face), the four static side
    walls `walls`, a kinematic capsule paddle spinning about y and a
    kinematic ball spinning in place."""
    from wgsparkl_tpu.collision.shapes import Collider
    from wgsparkl_tpu.pipeline import RigidBodyDesc

    return ([RigidBodyDesc(Collider.halfspace(), (0.0, 0.0, 0.0))] + list(walls)
            + [RigidBodyDesc(Collider.capsule(28.0, 1.5), (0.0, 2.0, 0.0),
                             rotation=(np.pi / 2, 0.0, 0.0), body_type="kinematic",
                             angvel=(0.0, -1.0, 0.0)),
               RigidBodyDesc(Collider.ball(2.5), (10.0, 2.0, 10.0),
                             body_type="kinematic", angvel=(0.0, 1.0, 0.0))])


def jax_scene_shapes(shift=(0.0, 0.0, 0.0), chan_free=False) -> MpmData:
    """sand_box_3d(nxz=8, ny=16)'s lattice, models and grid with the
    analytic-shapes bodies (shapes_bodies) at by=8, group=256, in the
    gathered-hybrid or the chan-free CDF mode (None: the heuristic)."""
    d3 = scenes.sand_box_3d(nxz=8, ny=16, cell_width=1.0, with_paddle=False)
    p = d3.state.particles
    if any(shift):
        p = p.replace(pos=p.pos + jnp.asarray(shift, jnp.float32))
    return MpmData(d3.params, p, d3.state.models, shapes_bodies(d3.bodies_desc[1:5]),
                   1.0, grid=d3.config.grid, transfer="pallas", group=GROUP,
                   job_chunk=8, by=BY, chan_free=chan_free)


def jax_scene_16() -> MpmData:
    """The 16-collider scene of tests/test_pallas_transfer.py
    (test_pallas_16_colliders_affinity_bits): 15 static balls through a
    falling sand lattice and a floor cuboid last, by=4, group=128."""
    from wgsparkl_tpu.collision.shapes import Collider
    from wgsparkl_tpu.models import DruckerPrager, ElasticCoefficients
    from wgsparkl_tpu.models.drucker_prager import drucker_prager_arrays
    from wgsparkl_tpu.params import SimulationParams
    from wgsparkl_tpu.pipeline import RigidBodyDesc
    from wgsparkl_tpu.solver import Models, Particles

    pos = scenes._lattice((8, 12, 8), 1.0, (-2.0, 1.2, -2.0))
    n = len(pos)
    particles = Particles.from_arrays(pos, density=2700.0, radius=0.25)
    elast = ElasticCoefficients.from_young_modulus(2.0e9, 0.2)
    dp = drucker_prager_arrays([DruckerPrager.new(2.0e9, 0.2)])
    models = Models.from_arrays(n, elast.lam, elast.mu,
                                dp={k: np.full(n, v[0]) for k, v in dp.items()})
    rng = np.random.RandomState(7)
    bodies = [RigidBodyDesc(Collider.ball(0.55),
                            tuple(rng.uniform((-2.5, 0.5, -2.5), (2.5, 4.0, 2.5))))
              for _ in range(15)]
    bodies.append(RigidBodyDesc(Collider.cuboid(40.0, 1.0, 40.0), (0.0, -1.0, 0.0)))
    params = SimulationParams.new(dt=(1.0 / 60.0) / 20,
                                  gravity=np.array([0.0, -9.81, 0.0]))
    return MpmData(params, particles, models, bodies, 1.0,
                   grid_bounds=(np.array([-8.0, -2.0, -8.0]),
                                np.array([8.0, 12.0, 8.0])),
                   transfer="pallas", group=128, job_chunk=8)


def jax_scene_kinematic() -> MpmData:
    """Every collider kinematic (the per-substep dense node CDF): the
    sand_box_3d(nxz=8, ny=16) lattice lowered 3 cells onto the capsule
    paddle of shapes_bodies, over a halfspace floor sliding along x, with a
    spinning ball at the lattice's corner."""
    from wgsparkl_tpu.collision.shapes import Collider
    from wgsparkl_tpu.pipeline import RigidBodyDesc

    d3 = scenes.sand_box_3d(nxz=8, ny=16, cell_width=1.0, with_paddle=False)
    p = d3.state.particles
    p = p.replace(pos=p.pos + jnp.asarray([0.0, -3.0, 0.0], jnp.float32))
    bodies = [
        RigidBodyDesc(Collider.halfspace(), (0.0, 0.0, 0.0), body_type="kinematic",
                      linvel=(0.5, 0.0, 0.0)),
        RigidBodyDesc(Collider.capsule(28.0, 1.5), (0.0, 2.0, 0.0),
                      rotation=(np.pi / 2, 0.0, 0.0), body_type="kinematic",
                      angvel=(0.0, -1.0, 0.0)),
        RigidBodyDesc(Collider.ball(1.0), (2.0, 6.0, 2.0), body_type="kinematic",
                      angvel=(1.0, 0.0, 0.0)),
    ]
    return MpmData(d3.params, p, d3.state.models, bodies, 1.0,
                   grid=d3.config.grid, transfer="pallas", group=GROUP,
                   job_chunk=8, by=BY)


def jax_scene_2d_moving(chan_free: bool = False) -> MpmData:
    """sand_column_2d(nx=24, ny=48, cell width 0.5) with a kinematic ball
    and a kinematic capsule stirring the column's foot (the reference's
    sand2 stirrers) over its static floor, group=128, in the dense or the
    chan-free CDF mode."""
    from wgsparkl_tpu.collision.shapes import Collider
    from wgsparkl_tpu.pipeline import RigidBodyDesc

    d2 = scenes.sand_column_2d(nx=24, ny=48, cell_width=0.5, transfer="pallas",
                               group=GROUP_2D)
    bodies = list(d2.bodies_desc) + [
        RigidBodyDesc(Collider.ball(0.8), (-1.5, 1.5), body_type="kinematic",
                      angvel=1.0),
        RigidBodyDesc(Collider.capsule(1.0, 0.3), (1.5, 1.2), rotation=1.2,
                      body_type="kinematic", angvel=-1.0),
    ]
    return MpmData(d2.params, d2.state.particles, d2.state.models, bodies, 0.5,
                   grid=d2.config.grid, transfer="pallas", group=GROUP_2D,
                   chan_free=chan_free)


# A kinematic ball (radius 0.8) with the small sand column and no floor:
# aside, at the grid's right edge level with the column's top, where the
# CDF-mode heuristic picks chan-free; under the column's foot, where it
# catches the falling matter and the heuristic picks the gathered modes.
BALL_2D = {"aside": (47.5, 12.375), "under": (0.0, -0.3)}


def jax_scene_2d_ball(where: str) -> MpmData:
    """sand_column_2d(nx=24, ny=48, cell width 0.5, group=128)'s lattice,
    models and grid with one kinematic ball at BALL_2D[where] in place of
    the floor; the CDF mode from the construction-time heuristic."""
    from wgsparkl_tpu.collision.shapes import Collider
    from wgsparkl_tpu.pipeline import RigidBodyDesc

    d2 = scenes.sand_column_2d(nx=24, ny=48, cell_width=0.5, transfer="pallas",
                               group=GROUP_2D)
    ball = RigidBodyDesc(Collider.ball(0.8), BALL_2D[where], body_type="kinematic")
    return MpmData(d2.params, d2.state.particles, d2.state.models, [ball], 0.5,
                   grid=d2.config.grid, transfer="pallas", group=GROUP_2D)


def port_bodies(descs):
    """The port's RigidBodyDesc list of JAX package bodies."""
    from wgsparkl_tpu_torch.collision.shapes import Collider
    from wgsparkl_tpu_torch.pipeline import RigidBodyDesc

    return [RigidBodyDesc(Collider(d.collider.shape_type, tuple(d.collider.params),
                                   vertices=d.collider.vertices,
                                   indices=d.collider.indices),
                          tuple(d.translation), d.rotation, d.body_type, d.density,
                          d.linvel, d.angvel) for d in descs]


def port_data(jdata: MpmData, chan_free=False, fold_vel=None):
    """The port's MpmData of a JAX scene's initial particles, models and
    bodies, on its grid, blocks, group and job table size, bounded or
    sparse with its kmax and amax (chan_free None: the heuristic)."""
    from wgsparkl_tpu_torch import interop
    from wgsparkl_tpu_torch.pipeline import MpmData as TMpmData

    cfg = jdata.config
    st = interop.state_from_reference(jdata.state, "cpu")
    return TMpmData(interop.params_from_reference(jdata.params, "cpu"), st.particles,
                    st.models, port_bodies(jdata.bodies_desc), cfg.grid.cell_width,
                    grid=interop.config_from_reference(cfg).grid, group=cfg.group,
                    max_jobs=cfg.max_jobs, by=cfg.by, chan_free=chan_free,
                    fold_vel=fold_vel, sparse=cfg.sparse, kmax=cfg.kmax,
                    amax=cfg.amax)


_jax_step_pallas = jax.jit(jax_step_pallas, static_argnums=(2, 3))


def run_both(jdata, substeps=10, each=False):
    """(JAX state, port state) after `substeps` from the same state; each:
    one substep at a time, both started from the JAX state, and `each`
    called on every pair."""
    from wgsparkl_tpu_torch import interop
    from wgsparkl_tpu_torch.pipeline import step_pallas

    cfg = interop.config_from_reference(jdata.config)
    tdata = port_data(jdata, chan_free=jdata.config.chan_free)
    assert cfg == tdata.config
    params = interop.params_from_reference(jdata.params, "cpu")
    if not each:
        return (_jax_step_pallas(jdata.state, jdata.params, jdata.config, substeps),
                step_pallas(tdata.state, params, cfg, substeps))
    state = jdata.state
    for _ in range(substeps):
        ref = _jax_step_pallas(state, jdata.params, jdata.config, 1)
        out = step_pallas(interop.state_from_reference(state, "cpu"), params, cfg, 1)
        each(ref, out)
        state = ref
    return ref, out
