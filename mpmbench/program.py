"""The system under test: the scene built through wgsparkl_tpu_torch's public
API (Particles, Models, Collider, RigidBodyDesc, MpmData) from the inputs
of mpmbench/scene.py (each collider's shape by its kind's part,
program_colliders/<kind>.py), and its state copied, restored and read back.

Only this module and the run's driver import the program; the reference
never does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpmbench import scene


def build(inputs, device):
    """MpmData of the inputs on `device`."""
    from wgsparkl_tpu_torch.models import DruckerPrager, ElasticCoefficients
    from wgsparkl_tpu_torch.models.drucker_prager import drucker_prager_arrays
    from wgsparkl_tpu_torch.models.elasticity import lame_lambda_mu
    from wgsparkl_tpu_torch.params import SimulationParams
    from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc
    from wgsparkl_tpu_torch.solver import Models, Particles

    cfg, mat = inputs.config, inputs.material
    n = len(inputs.pos)
    particles = Particles.from_arrays(inputs.pos, density=mat["density"],
                                      radius=inputs.h * mat["radius_cells"], device=device)
    elast = ElasticCoefficients.from_young_modulus(mat["young_modulus"],
                                                   mat["poisson_ratio"])
    dp = None
    if mat["plasticity"] is not None:
        p = mat["plasticity"]
        lam, mu = lame_lambda_mu(p["young_modulus"], p["poisson_ratio"])
        law = DruckerPrager(h0=float(np.radians(p["h0_deg"])),
                            h1=float(np.radians(p["h1_deg"])), h2=float(p["h2"]),
                            h3=float(np.radians(p["h3_deg"])), lam=float(lam), mu=float(mu))
        dp = {k: np.full(n, v[0]) for k, v in drucker_prager_arrays([law]).items()}
    models = Models.from_arrays(n, elast.lam, elast.mu, dp=dp, phase=mat["phase"],
                                max_stretch=mat["max_stretch"], device=device)
    bodies = [RigidBodyDesc(scene.load_part("program_colliders", c.kind).shape(c),
                            c.translation, rotation=c.rotation, body_type=c.body_type,
                            linvel=c.linvel, angvel=c.angvel)
              for c in inputs.colliders]
    params = SimulationParams.new(dt=inputs.dt, gravity=inputs.gravity.tolist(),
                                  device=device)
    return MpmData(params, particles, models, bodies, inputs.h,
                   grid_bounds=(inputs.grid_lo, inputs.grid_hi),
                   transfer=cfg["transfer"], group=cfg["group"], by=cfg["by"],
                   max_jobs=cfg["max_jobs"] if isinstance(cfg.get("max_jobs"), int) else 0)


def _copy(x, device):
    if isinstance(x, torch.Tensor):
        return x.clone() if device is None else x.to(device, copy=True)
    if isinstance(x, dict):
        return {k: _copy(v, device) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _copy(getattr(x, f.name), device)
                                         for f in dataclasses.fields(x)})
    return x


def copy_state(state, device=None):
    """A copy of a SimState, every tensor cloned in place or copied to
    `device` (the host, for a snapshot that takes no device memory)."""
    return _copy(state, device)


def read_state(state, device=None) -> dict:
    """The particles' and bodies' state as float64 / int64 tensors on the
    state's device (or on `device`), rows in the program's particle order,
    with `ids` the scene's particle index of each row."""
    p, m, b = state.particles, state.models, state.bodies
    out = {
        "ids": p.ids.long(), "pos": p.pos.double(), "vel": p.vel.double(),
        "F": p.def_grad.double(), "affine": p.affine.double(),
        "aff": p.cdf_affinity.long() & 0xFFFFFFFF, "phase": m.phase.double(),
        "dps": {k: v.double() for k, v in m.dp_state.items()},
        "mass": p.mass.double(), "vol0": p.init_volume.double(),
        "lam": m.lam.double(), "mu": m.mu.double(),
        "dp": {k: v.double() for k, v in m.dp.items()},
        "stretch": m.max_stretch.double(),
        "bodies": {"pos": b.pos.double(), "rot": b.rot.double(),
                   "linvel": b.linvel.double(), "angvel": b.angvel.double()},
    }
    return out if device is None else _copy(out, device)


def substep_counts(data, state) -> tuple:
    """(the state after one pallas substep from `state`, the counts of that
    substep that the kernels' costs take): the program's record of the
    substep (pipeline.step_pallas with `record`), which equals a substep
    of a frame when no collider is static.  The counts hold the live jobs
    at gate level 2 (nj2) and the moving colliders that kernels A and B
    evaluate at those jobs' windows (n_moving: the gathered-hybrid mode's;
    none in the dense mode, whose tiles hold them)."""
    from wgsparkl_tpu_torch.pipeline import step_pallas

    cfg = data.config
    rec = {}
    out = step_pallas(state, data.params, cfg, 1, record=rec)
    ln, jb = rec["jobs"]["len"], rec["jbody"]
    live = ln > 0
    sids = rec["sorted_ids"]
    d = cfg.grid.dim
    counts = {
        "dim": d, "ce": int(rec["covered_end"]), "pg": int(ln[live & (jb > 0)].sum()),
        "nj": int(live.sum()), "njg": int((live & (jb > 0)).sum()),
        "nj2": int((live & (jb == 2)).sum()), "n_moving": len(rec.get("moving", ())),
        "nc": cfg.num_colliders, "npad": rec["rows"].shape[1],
        "pchan": rec["unsorted"].shape[0], "wv": rec["ntiles"].shape[1],
        "group": cfg.group, "n_first": int((sids[1:] != sids[:-1]).sum()) + 1,
        "nb_total": int(rec["nb_total"]),
    }
    meshes = state.meshes
    if meshes is not None:
        from wgsparkl_tpu_torch.ops.rigid_cdf import world_transform

        sample_w, _ = world_transform(meshes, state.bodies)
        dev = sample_w.device
        base = (torch.round(sample_w / cfg.grid.cell_width) - 1
                - torch.tensor(cfg.grid.origin_cell, device=dev))
        inside = ((base >= 0) & (base < torch.tensor(cfg.grid.shape, device=dev))).all(1)
        counts.update(samples=meshes.count, vertex_floats=meshes.vertices_local.numel(),
                      nodes=int(np.prod(cfg.grid.shape)),
                      pairs=int(inside.sum()) * 3 ** d)
    return out, counts
