"""Plain MLS-MPM with CPIC against fixed and kinematic colliders: the
reference that decides `correct`.

One substep, in upstream wgsparkl's order and semantics, on a dense
row-major node grid: the colliders' node CDF at the bodies' poses (each
kind's part, colliders/<kind>.py; reference/mesh.py for meshes); the
particle CDF (the union of the stencil nodes' affinity bits, a sign vote
per collider weighted by w * distance, a collider the particle already had
keeping its sign, then the signed distance and normal by weighted least
squares over the nodes sharing affinity; a fit with det <= 1e-8 gives
nothing); P2G of the compatible pairs (APIC, the affine matrix carrying
the stress), the incompatible pairs' impulses going to the node's closest
body (fixed or kinematic here, of infinite mass: they move none, and none
is summed); the grid update (gravity, each component clamped to one cell a
substep); G2P with the ghost velocity at incompatible nodes (the closest
body's velocity at the node plus the friction-cone projection of the
particle's velocity relative to it, on its normal), the particle's own
velocity at incompatible nodes with no body; the particle update (contact
projection, relative to the summed velocity of the bodies in its affinity
word, of a particle deeper than 0.05 h, the speed clamp, advection, the
penalty impulse, F update, the fracture check on the signed singular
values, the Drucker-Prager return map of failed or granular particles,
corotated stress, the new affine matrix).  The bodies' poses advance
apart (reference/bodies.py).

Written from tests/oracle_mpm.py and tests/oracle_cpic.py (per-particle
loops transcribed from upstream's WGSL) as batched torch over particles
and stencil nodes.  It imports nothing of the program under test and runs
in any floating dtype; float64 is the reference, bfloat16 the control
(linear algebra that torch has no bfloat16 kernel for is done in float32
and rounded back).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from mpmbench.reference.bodies import velocity_at

FRICTION = 20.0
PENALTY = 1.0e3


@dataclasses.dataclass(frozen=True)
class Grid:
    """Nodes at world positions (origin + i) * h per axis, row-major."""

    origin: tuple
    shape: tuple
    h: float

    @property
    def dim(self) -> int:
        return len(self.shape)

    @property
    def num_nodes(self) -> int:
        return math.prod(self.shape)

    def flat(self, cell):
        idx = cell[..., 0] - self.origin[0]
        for a in range(1, self.dim):
            idx = idx * self.shape[a] + (cell[..., a] - self.origin[a])
        return idx

    def inside(self, cell):
        ok = None
        for a in range(self.dim):
            i = cell[..., a] - self.origin[a]
            o = (i >= 0) & (i < self.shape[a])
            ok = o if ok is None else ok & o
        return ok

    @staticmethod
    def from_bounds(lo, hi, h: float, margin: int = 3) -> "Grid":
        """The domain [lo, hi] with `margin` cells on each side, rounded up
        to whole 4^3 (3D) or 8^2 (2D) blocks."""
        bs = 4 if len(lo) == 3 else 8
        origin = [math.floor(x / h) - margin for x in lo]
        top = [math.ceil(x / h) + margin for x in hi]
        shape = [-((t - o + 1) // -bs) * bs for o, t in zip(origin, top)]
        return Grid(tuple(origin), tuple(shape), float(h))


@dataclasses.dataclass
class Material:
    """Per-particle constants [N] (or scalars), in the reference's dtype."""

    mass: torch.Tensor
    vol0: torch.Tensor
    lam: torch.Tensor
    mu: torch.Tensor
    stretch: torch.Tensor
    dp: Optional[dict] = None     # h0..h3, lam, mu of Drucker-Prager, or None


@dataclasses.dataclass
class Colliders:
    """The colliders' node CDF at one substep's poses."""

    dist: torch.Tensor
    closest: torch.Tensor
    aff: torch.Tensor
    count: int


def _lin(fn, *xs):
    """Linear algebra in the inputs' dtype, or in float32 for bfloat16."""
    low = xs[0].dtype == torch.bfloat16
    out = fn(*(x.float() if low else x for x in xs))
    if not low:
        return out
    return tuple(o.bfloat16() for o in out) if isinstance(out, tuple) else out.bfloat16()


def signed_svd(f):
    """F = U diag(s) V^T with U, V rotations; a negative determinant puts
    its sign on the smallest singular value."""
    u, s, vh = _lin(torch.linalg.svd, f)
    du, dv = _lin(torch.linalg.det, u), _lin(torch.linalg.det, vh)
    flip_u = (du < 0).to(f.dtype)
    flip_v = (dv < 0).to(f.dtype)
    d = f.shape[-1]
    last = torch.zeros(d, dtype=f.dtype, device=f.device)
    last[-1] = 1.0
    u = u * (1 - 2 * flip_u[:, None, None] * last[None, None, :])
    vh = vh * (1 - 2 * flip_v[:, None, None] * last[None, :, None])
    s = s * (1 - 2 * flip_u[:, None] * last) * (1 - 2 * flip_v[:, None] * last)
    return u, s, vh


def _stencil(pos, h):
    """Base cells [N, d], weights [N, K] and node - particle [N, K, d] of
    the quadratic B-spline (base round(p / h) - 1, halves to even)."""
    n, d = pos.shape
    u = pos / h
    base = torch.round(u).long() - 1
    fx = u - base.to(pos.dtype)
    wa = torch.stack([0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1.0) ** 2,
                      0.5 * (fx - 0.5) ** 2], -1)                 # [N, d, 3]
    offs = torch.cartesian_prod(*([torch.arange(3, device=pos.device)] * d)).reshape(-1, d)
    w = torch.ones((n, offs.shape[0]), dtype=pos.dtype, device=pos.device)
    for a in range(d):
        w = w * wa[:, a, :][:, offs[:, a]]
    cells = base[:, None, :] + offs[None]
    dpt = cells.to(pos.dtype) * h - pos[:, None, :]
    return cells, w, dpt


def _compatible(a_node, a_part):
    common = a_node & a_part & 0xFFFF
    return ((a_node >> 16) & common) == ((a_part >> 16) & common)


def _project(vel, normal):
    """Friction-cone projection of relative velocities [.., d] on normals."""
    nv = (vel * normal).sum(-1, keepdim=True)
    tang = vel - normal * nv
    tl = torch.sqrt((tang * tang).sum(-1, keepdim=True))
    tdir = torch.where(tl > 1e-8, tang / torch.clamp(tl, min=1e-30), torch.zeros_like(tang))
    return torch.where(nv < 0, tdir * torch.clamp(tl + FRICTION * nv, min=0.0), vel)


def particle_cdf(pos, prev_aff, col: Colliders, grid: Grid, cells, w, dpt):
    """(affinity word [N] int64, signed distance [N], normal [N, d])."""
    n, d = pos.shape
    valid = grid.inside(cells)
    flat = torch.where(valid, grid.flat(cells), 0)
    a = torch.where(valid, col.aff[flat], 0)
    dist = torch.where(valid, col.dist[flat], 0).to(pos.dtype)
    dist = torch.where(torch.isfinite(dist), dist, torch.zeros_like(dist))
    or_all = torch.zeros_like(prev_aff)
    for k in range(a.shape[1]):
        or_all = or_all | a[:, k]
    sign_word = torch.zeros_like(prev_aff)
    wd = w * dist
    for c in range(col.count):
        has = ((a >> c) & 1) != 0
        below = ((a >> (16 + c)) & 1) != 0
        vote = torch.where(has, torch.where(below, -wd, wd), torch.zeros_like(wd)).sum(1)
        keep = ((prev_aff >> c) & 1) != 0
        s = torch.where(keep, ((prev_aff >> (16 + c)) & 1) != 0, vote < 0)
        sign_word = sign_word | (s.long() << c)
    p_aff = (or_all & 0xFFFF) | (sign_word << 16)
    common = a & p_aff[:, None] & 0xFFFF
    differ = (((a >> 16) ^ (p_aff[:, None] >> 16)) & common) != 0
    sdist = torch.where(differ, -dist, dist)
    wk = torch.where(common != 0, w, torch.zeros_like(w))
    pv = torch.cat([dpt, torch.ones_like(dpt[..., :1])], -1)       # [N, K, d + 1]
    qtq = torch.einsum("nk,nki,nkj->nij", wk, pv, pv)
    qtu = torch.einsum("nk,nki->ni", wk * sdist, pv)
    det = _lin(torch.linalg.det, qtq)
    ok = det > 1e-8
    eye = torch.eye(d + 1, dtype=pos.dtype, device=pos.device)
    safe = torch.where(ok[:, None, None], qtq, eye)
    sol = _lin(torch.linalg.solve, safe, qtu.unsqueeze(-1)).squeeze(-1)
    nl = torch.sqrt((sol[:, :d] ** 2).sum(1, keepdim=True))
    normal = torch.where(ok[:, None] & (nl > 1e-6), sol[:, :d] / torch.clamp(nl, min=1e-30),
                         torch.zeros_like(sol[:, :d]))
    zero = torch.zeros_like(sol[:, d])
    return (torch.where(ok, p_aff, torch.zeros_like(p_aff)), torch.where(ok, sol[:, d], zero),
            normal)


def drucker_prager(dp, dps, u, s, vh):
    """Return map on the signed SVD of F; (new F or None where unchanged,
    new state, applied mask)."""
    d = s.shape[1]
    q = dps["hardening"]
    angle = dp["h0"] + (dp["h1"] * q - dp["h3"]) * torch.exp(-dp["h2"] * q)
    sa = torch.sin(angle)
    alpha = math.sqrt(2.0 / 3.0) * 2.0 * sa / (3.0 - sa)
    strain = torch.log(torch.clamp(s, min=1e-12)) + (dps["log_vol_gain"] / d)[:, None]
    trace = strain.sum(1)
    dev = strain - (trace / d)[:, None]
    dev_norm = torch.sqrt((dev * dev).sum(1))
    case_a = (trace > 0) | (dev_norm == 0)
    gamma = dev_norm + (d * dp["lam"] + 2.0 * dp["mu"]) / (2.0 * dp["mu"]) * trace * alpha
    case_b = ~case_a & (gamma <= 0)
    hcorr = strain - dev * (gamma / torch.clamp(dev_norm, min=1e-20))[:, None]
    new_s = torch.where(case_a[:, None], torch.ones_like(s), torch.exp(hcorr))
    hard = torch.where(case_a, torch.sqrt((strain * strain).sum(1)), gamma)
    apply = (dp["lam"] > 0) & ~case_b
    prev_det, new_det = s.prod(1), new_s.prod(1)
    state = {
        "det": torch.where(apply, dps["det"] * prev_det / new_det, dps["det"]),
        "hardening": torch.where(apply, q + hard, q),
        "log_vol_gain": torch.where(
            apply, dps["log_vol_gain"] + torch.log(torch.clamp(prev_det, min=1e-20))
            - torch.log(torch.clamp(new_det, min=1e-20)), dps["log_vol_gain"]),
    }
    f_new = u @ torch.diag_embed(new_s) @ vh
    return f_new, state, apply


def substep(st: dict, mat: Material, col: Colliders, bodies: dict, grid: Grid, dt: float,
            gravity):
    """One substep of the state dict (pos, vel, F, affine [N, d, d], aff
    int64, phase, dps {det, hardening, log_vol_gain}) against the node CDF
    col of the bodies (pos, rot, linvel, angvel: reference/bodies.py) at
    their poses: the new particles' state."""
    pos, vel = st["pos"], st["vel"]
    n, d = pos.shape
    h = grid.h
    dtp = pos.dtype
    inv_d = 4.0 / (h * h)
    m = grid.num_nodes
    cells, w, dpt = _stencil(pos, h)
    aff, sd, normal = particle_cdf(pos, st["aff"], col, grid, cells, w, dpt)

    valid = grid.inside(cells)
    flat = torch.where(valid, grid.flat(cells), 0)
    w_in = torch.where(valid, w, torch.zeros_like(w))
    n_aff = torch.where(valid, col.aff[flat], 0)
    n_cl = torch.where(valid, col.closest[flat], -1)
    comp = _compatible(n_aff, aff[:, None])
    # P2G of the compatible pairs.
    mom = torch.einsum("nij,nkj->nki", st["affine"], dpt) + (mat.mass[:, None] * vel)[:, None, :]
    take = (comp & valid).to(dtp) * w_in
    grid_mm = torch.zeros((m, d + 1), dtype=dtp, device=pos.device)
    grid_mm.index_add_(0, flat.reshape(-1), torch.cat(
        [(take[..., None] * mom).reshape(-1, d),
         (take * mat.mass[:, None]).reshape(-1, 1)], 1))
    # The incompatible pairs' impulses go to bodies of infinite mass, which
    # they do not move: none is summed.  The ghost velocity: the closest
    # body's velocity at the node plus the projected relative velocity.
    bv = velocity_at(bodies, torch.clamp(n_cl, min=0), cells.to(dtp) * h)
    ghost = bv + _project(vel[:, None, :] - bv, normal[:, None, :].expand_as(dpt))
    # Grid update.
    mass = grid_mm[:, d:]
    limit = float(torch.tensor(h, dtype=torch.float32)) / float(torch.tensor(dt, dtype=torch.float32))
    gvel = torch.where(mass > 0, (grid_mm[:, :d] + mass * gravity * dt) / torch.where(
        mass > 0, mass, torch.ones_like(mass)), torch.zeros_like(mass))
    gvel = torch.clamp(gvel, -limit, limit)
    # G2P with ghost velocities.
    eff = torch.where(comp[..., None], gvel[flat],
                      torch.where((n_cl >= 0)[..., None], ghost, vel[:, None, :]))
    new_v = (w_in[..., None] * eff).sum(1)
    grad = inv_d * torch.einsum("nk,nki,nkj->nij", w_in, eff, dpt)
    # Particle update: contact projection relative to the bodies the
    # particle is affine to, clamp, advection, penalty.
    rv = torch.zeros_like(new_v)
    for c in range(col.count):
        rv = rv + torch.where((((aff >> c) & 1) != 0)[:, None], velocity_at(bodies, c, pos),
                              torch.zeros_like(rv))
    penetrating = (sd < -0.05 * h)[:, None]
    new_v = torch.where(penetrating, rv + _project(new_v - rv, normal), new_v)
    speed = torch.sqrt((new_v * new_v).sum(1, keepdim=True))
    new_v = torch.where(speed > limit, new_v * (limit / torch.clamp(speed, min=1e-30)), new_v)
    new_pos = pos + new_v * dt
    new_v = torch.where(penetrating, new_v + dt * -torch.clamp(sd, min=-0.3 * h)[:, None]
                        * PENALTY * normal, new_v)
    new_f = st["F"] + dt * grad @ st["F"]
    u, s, vh = signed_svd(new_f)
    over = (s > mat.stretch[:, None]).any(1)
    phase = torch.where((st["phase"] > 0) & (mat.stretch > 0) & over,
                        torch.zeros_like(st["phase"]), st["phase"])
    dps = st["dps"]
    if mat.dp is not None:
        f_dp, dps_new, applied = drucker_prager(mat.dp, dps, u, s, vh)
        granular = phase == 0
        apply = granular & applied
        new_f = torch.where(apply[:, None, None], f_dp, new_f)
        dps = {k: torch.where(granular, dps_new[k], dps[k]) for k in dps}
        u2, s2, vh2 = signed_svd(new_f)
        u = torch.where(apply[:, None, None], u2, u)
        s = torch.where(apply[:, None], s2, s)
        vh = torch.where(apply[:, None, None], vh2, vh)
    j = s.prod(1)
    rot = u @ vh
    eye = torch.eye(d, dtype=dtp, device=pos.device)
    stress = (2.0 * mat.mu[:, None, None] * (new_f - rot) @ new_f.transpose(1, 2)
              + (mat.lam * (j - 1.0) * j)[:, None, None] * eye)
    affine = grad * mat.mass[:, None, None] - stress * (mat.vol0 * inv_d * dt)[:, None, None]
    return {"pos": new_pos, "vel": new_v, "F": new_f, "affine": affine, "aff": aff,
            "phase": phase, "dps": dps, "sd": sd, "normal": normal}
