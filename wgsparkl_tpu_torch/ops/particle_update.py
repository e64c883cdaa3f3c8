"""Fused particle update (port of wgsparkl_tpu/ops/particle_update.py):
contact projection, velocity clamp, advection, penalty impulse, F update,
fracture check, Drucker-Prager projection, corotated or neo-Hookean stress
and the APIC affine matrix.  `particle_update_channels` (either dimension)
and `particle_update_channels_2d` are the channel form, the plain version
of kernel C (ops/update_rows.py); `particle_update` is the JAX package's
struct form, which runs kernel C on the row matrix of a Particles state."""

from __future__ import annotations

import dataclasses

import torch

from wgsparkl_tpu_torch.math import div
from wgsparkl_tpu_torch.math.svd import det3_ch, eig33_sigma_ch, svd2x2_ch
from wgsparkl_tpu_torch.models.drucker_prager import (
    drucker_prager_project_ch, drucker_prager_project_ch2,
)
from wgsparkl_tpu_torch.models.elasticity import (
    kirchoff_stress_corotated_ch, kirchoff_stress_corotated_ch2,
    kirchoff_stress_neo_hookean_ch, kirchoff_stress_neo_hookean_ch2,
)
from wgsparkl_tpu_torch.ops.kernel import inv_d
from wgsparkl_tpu_torch.ops import rows as R
from wgsparkl_tpu_torch.ops import rows2d as R2
from wgsparkl_tpu_torch.ops.rows import DEFAULT_FRICTION
from wgsparkl_tpu_torch.ops.transfer import particle_cdf_rows
from wgsparkl_tpu_torch.params import velocity_limit
from wgsparkl_tpu_torch.solver import DPS_KEYS, attach_material_table

PENALTY_COEFF = 1.0e3
ELASTIC_MODELS = ("corotated", "neo_hookean")   # index = kernel C's model id
_STRESS = {("corotated", 3): kirchoff_stress_corotated_ch,
           ("corotated", 2): kirchoff_stress_corotated_ch2,
           ("neo_hookean", 3): kirchoff_stress_neo_hookean_ch,
           ("neo_hookean", 2): kirchoff_stress_neo_hookean_ch2}


def _dot(a, b):
    acc = a[0] * b[0]
    for k in range(1, len(a)):
        acc = acc + a[k] * b[k]
    return acc


def _fracture_3d(new_f, ch):
    sig = eig33_sigma_ch(new_f)
    detf = det3_ch(new_f)
    smin = torch.minimum(torch.minimum(sig[0], sig[1]), sig[2])
    sgn = torch.where(detf < 0.0, -1.0, 1.0)
    over = None
    for s in sig:
        o = s * torch.where(s == smin, sgn, 1.0) > ch["stretch"]
        over = o if over is None else over | o
    return over


def _fracture_2d(new_f, ch):
    """The signed 2x2 SVD carries sign(det F) on its smaller value."""
    _, sig, _ = svd2x2_ch(new_f)
    return (sig[0] > ch["stretch"]) | (sig[1] > ch["stretch"])


def particle_update_channels(ch, dt: float, h: float,
                             elastic_model: str = "corotated"):
    """ch: dict of [N] channels (pos[d], vel[d], grad{(i,j)}, F{(i,j)}, sd,
    normal[d], rigid_vel[d], mass, vol0, lam, mu, dp{}, dps{}, phase,
    stretch), d = 3, or d = 2 for particle_update_channels_2d.  Returns
    dict(pos, vel, F, affine, phase, dps).  elastic_model: "corotated" or
    "neo_hookean" (the stress of the elastic part)."""
    vel, nrm, rv, sd = ch["vel"], ch["normal"], ch["rigid_vel"], ch["sd"]
    d = len(vel)
    penetrating = sd < -0.05 * h
    rel = [vel[i] - rv[i] for i in range(d)]
    nv = _dot(rel, nrm)
    tang = [rel[i] - nrm[i] * nv for i in range(d)]
    tl = torch.sqrt(_dot(tang, tang))
    inv_tl = torch.where(tl > 1e-8, 1.0 / torch.clamp(tl, min=1e-30), 0.0)
    scale = torch.clamp(tl + DEFAULT_FRICTION * nv, min=0.0) * inv_tl
    proj = [torch.where(nv < 0.0, tang[i] * scale, rel[i]) for i in range(d)]
    new_vel = [torch.where(penetrating, rv[i] + proj[i], vel[i]) for i in range(d)]

    speed = torch.sqrt(_dot(new_vel, new_vel))
    limit = velocity_limit(h, dt)
    cl = torch.where(speed > limit, div(limit, torch.clamp(speed, min=1e-30)), 1.0)
    new_vel = [v * cl for v in new_vel]
    new_pos = [ch["pos"][i] + new_vel[i] * dt for i in range(d)]

    corrected = torch.clamp(sd, min=-0.3 * h)
    pen = dt * -corrected * PENALTY_COEFF
    new_vel = [torch.where(penetrating, new_vel[i] + pen * nrm[i], new_vel[i])
               for i in range(d)]

    fc, gc = ch["F"], ch["grad"]
    new_f = {}
    for i in range(d):
        for j in range(d):
            acc = gc[(i, 0)] * fc[(0, j)]
            for k in range(1, d):
                acc = acc + gc[(i, k)] * fc[(k, j)]
            new_f[(i, j)] = fc[(i, j)] + dt * acc

    check = (ch["phase"] > 0.0) & (ch["stretch"] > 0.0)
    over = (_fracture_3d if d == 3 else _fracture_2d)(new_f, ch)
    new_phase = torch.where(check & over, 0.0, ch["phase"])

    project = drucker_prager_project_ch if d == 3 else drucker_prager_project_ch2
    dp_state, f_proj = project(ch["dp"], ch["dps"], new_f)
    granular = new_phase == 0.0
    new_f = {k: torch.where(granular, f_proj[k], new_f[k]) for k in new_f}
    new_dps = {k: torch.where(granular, dp_state[k], ch["dps"][k])
               for k in dp_state}
    stress = _STRESS[elastic_model, d](ch["lam"], ch["mu"], new_f)
    scale_a = ch["vol0"] * inv_d(h) * dt
    affine = {k: gc[k] * ch["mass"] - stress[k] * scale_a for k in new_f}
    return {"pos": new_pos, "vel": new_vel, "F": new_f, "affine": affine,
            "phase": new_phase, "dps": new_dps}


def particle_update_channels_2d(ch, params, grid_cfg, elastic_model="corotated"):
    """particle_update_channels on 2D channels with the JAX package's
    arguments (the step's params, the grid)."""
    return particle_update_channels(ch, params.dt, grid_cfg.cell_width, elastic_model)


def particle_update(particles, models, params, grid_cfg, elastic_model="corotated"):
    """One constitutive step of a Particles state (the JAX package's struct
    form): (particles with new pos, vel, def_grad and affine; models with
    new phase and dp_state).  particles.affine holds the velocity gradient
    (g2p's), particles.cdf_rigid_vel the rigid contact velocity.  Kernel C
    runs on the state's rows: the G2P moments it takes are S = D grad
    (`centered`, D = h^2 / 4, its gradient D^-1 S), the rigid velocity comes
    from the rows (`rv_rows`), and every lane is live.  A models without a
    material table gets one here (kernel C reads the constants by id)."""
    # ops/update_rows imports this module (the plain version of kernel C).
    from wgsparkl_tpu_torch.ops.update_rows import update_rows, update_rows2d

    n, d = particles.pos.shape
    L, update = (R, update_rows) if d == 3 else (R2, update_rows2d)
    tabled = models
    if models.mat_table is None:
        tabled, _ = attach_material_table(particles, models, limit=None)
    dev = particles.pos.device
    h = grid_cfg.cell_width
    rows = L.pack_rows_padded(particles, tabled, n)
    krows = torch.zeros((16 if d == 3 else 8, n), dtype=torch.float32, device=dev)
    krows[:d] = particles.vel.T
    krows[d:d + d * d] = (particles.affine.reshape(n, d * d)
                          * R.f32(h * h / 4.0)).T
    pcdf = particle_cdf_rows(particles.cdf_affinity, particles.cdf_normal,
                             particles.cdf_signed_distance)
    out = update(rows, krows, pcdf,
                 torch.zeros(n, dtype=torch.int32, device=dev), n,
                 torch.zeros((32 if d == 3 else 16, 128), dtype=torch.float32,
                             device=dev),
                 tabled.mat_table, params.dt, h, 0, tabled.mat_table.shape[1], 1,
                 elastic_model, centered=True, rv_rows=True)
    new_p = dataclasses.replace(
        particles, pos=out[0:d].T.contiguous(), vel=out[d:2 * d].T.contiguous(),
        affine=out[L.A0:L.A0 + d * d].T.reshape(n, d, d).contiguous(),
        def_grad=out[L.R_F0:L.R_F0 + d * d].T.reshape(n, d, d).contiguous())
    new_m = dataclasses.replace(
        models, phase=out[L.R_PHASE].clone(),
        dp_state={k: out[L.R_DPS0 + i].clone() for i, k in enumerate(DPS_KEYS)})
    return new_p, new_m
