"""Carry state and configuration over from the JAX package.

The functions take the JAX package's SimState / SimulationParams /
MpmConfig objects but read only their fields, as numpy arrays and Python
values, so this module imports nothing of JAX.  The tests use them to start
the port from exactly the reference's state.
"""

from __future__ import annotations

import numpy as np
import torch

from wgsparkl_tpu_torch.device import resolve
from wgsparkl_tpu_torch.grid import GridConfig
from wgsparkl_tpu_torch.ops.rigid_cdf import MeshColliders
from wgsparkl_tpu_torch.ops.particle_update import ELASTIC_MODELS
from wgsparkl_tpu_torch.params import SimulationParams
from wgsparkl_tpu_torch.pipeline import MpmConfig, SimState
from wgsparkl_tpu_torch.rigid.body import RigidWorld
from wgsparkl_tpu_torch.solver import Models, Particles


def _t(x, device):
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(np.array(a), device=device)


def params_from_reference(params, device=None) -> SimulationParams:
    return SimulationParams(dt=float(np.asarray(params.dt, np.float32)),
                            gravity=_t(np.asarray(params.gravity, np.float32),
                                       resolve(device)))


def _plain(x):
    """A joint's static fields as plain Python values (tuples of floats)."""
    if isinstance(x, (tuple, list)) or (isinstance(x, np.ndarray) and x.ndim):
        return tuple(_plain(v) for v in x)
    return x if x is None or isinstance(x, str) else float(x)


def config_from_reference(cfg) -> MpmConfig:
    unsupported = {
        "spatial_devices": cfg.spatial_devices,
        "elastic_model": cfg.elastic_model not in ELASTIC_MODELS,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"configuration options not ported: {bad}")
    g = cfg.grid
    joints = tuple((int(j[0]), int(j[1]), *(_plain(x) for x in j[2:])) for j in cfg.joints)
    return MpmConfig(
        grid=GridConfig(tuple(g.shape), float(g.cell_width), tuple(g.origin_cell)),
        collider_types=tuple(cfg.collider_types), transfer=str(cfg.transfer),
        group=int(cfg.group), job_chunk=int(cfg.job_chunk),
        max_jobs=int(cfg.max_jobs), by=int(cfg.by),
        n_materials=int(cfg.n_materials), static_slots=tuple(cfg.static_slots),
        elastic_model=cfg.elastic_model, chan_free=bool(cfg.chan_free),
        fold_vel=bool(cfg.fold_vel), dynamic_slots=tuple(cfg.dynamic_slots),
        coupling=tuple(int(c) for c in cfg.coupling), joints=joints,
        mesh_cids=tuple(int(c) for c in cfg.mesh_cids),
        sample_group=int(cfg.sample_group), sample_chunk=int(cfg.sample_chunk),
        sample_max_jobs=int(cfg.sample_max_jobs), sparse=bool(cfg.sparse),
        kmax=int(cfg.kmax), amax=int(cfg.amax))


def meshes_from_reference(meshes, device=None):
    """The JAX package's MeshColliders (or None) as the port's, so that both
    packages start from the same samples."""
    if meshes is None:
        return None
    device = resolve(device)
    return MeshColliders(**{f: _t(getattr(meshes, f), device) for f in (
        "sample_local", "sample_prim", "sample_cid", "vertices_local", "vertex_cid")})


def state_from_reference(state, device=None) -> SimState:
    """2D or 3D state, as the reference holds it (2D bodies: rot (cos, sin),
    angvel [B, 1], inertia [B, 1, 1])."""
    device = resolve(device)
    p, m, b = state.particles, state.models, state.bodies
    particles = Particles(**{f: _t(getattr(p, f), device) for f in (
        "pos", "vel", "def_grad", "affine", "init_volume", "init_radius", "mass",
        "cdf_normal", "cdf_rigid_vel", "cdf_signed_distance", "cdf_affinity",
        "ids")})
    models = Models(
        lam=_t(m.lam, device), mu=_t(m.mu, device),
        dp={k: _t(v, device) for k, v in m.dp.items()},
        dp_state={k: _t(v, device) for k, v in m.dp_state.items()},
        phase=_t(m.phase, device), max_stretch=_t(m.max_stretch, device),
        mat_id=None if m.mat_id is None else _t(m.mat_id, device),
        mat_table=None if m.mat_table is None else _t(m.mat_table, device))
    bodies = RigidWorld(**{f: _t(getattr(b, f), device) for f in (
        "rot", "pos", "linvel", "angvel", "local_com", "world_com", "inv_mass",
        "inv_inertia_local", "inv_inertia_world", "shape_params")})
    return SimState(particles=particles, models=models, bodies=bodies,
                    meshes=meshes_from_reference(getattr(state, "meshes", None), device))
