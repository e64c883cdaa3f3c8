"""Channel-form fused particle update (port of
wgsparkl_tpu/ops/particle_update.py:105-306, `particle_update_channels` and
`particle_update_channels_2d`): contact projection, velocity clamp,
advection, penalty impulse, F update, fracture check, Drucker-Prager
projection, corotated or neo-Hookean stress and the APIC affine matrix.
The plain version of kernel C (ops/update_rows.py)."""

from __future__ import annotations

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
from wgsparkl_tpu_torch.ops.rows import DEFAULT_FRICTION
from wgsparkl_tpu_torch.params import velocity_limit

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
