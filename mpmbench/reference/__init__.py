"""The plain reference of a cell, built from the same inputs as the program
(mpmbench/scene.py) and from nothing the program made: its own grid, its
own surface samples and node CDF (each collider's by its kind's part,
colliders/<kind>.py, at its body's pose), its own material constants and
bodies (reference/bodies.py).

`Reference(inputs, device, dtype)` gives the initial state it derives from
the inputs (`initial`) and advances a state, particles and bodies, by one
frame of the configuration's substeps (`frame`) or by one substep
(`substep`).  The states are dicts of tensors as mpmbench/program.read_state
gives them.  The fixed colliders' node CDF is built once, at the poses the
configuration states; a kinematic collider's is built every substep, at
its body's pose in the state.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mpmbench import scene
from mpmbench.reference import bodies as body_ref
from mpmbench.reference.mpm import Colliders, Grid, Material, substep


class Reference:
    def __init__(self, inputs, device, dtype=torch.float64):
        self.inputs, self.device, self.dtype = inputs, device, dtype
        self.grid = Grid.from_bounds(inputs.grid_lo.tolist(), inputs.grid_hi.tolist(),
                                    inputs.h)
        cols = inputs.colliders
        self.kinematic = torch.tensor([c.kinematic for c in cols], device=device)
        # The fixed colliders' node CDF, once: their poses never change.
        self._parts = [None if c.kinematic else self._part(c, self._stated_pose(c))
                       for c in cols]
        self.colliders = None if any(c.kinematic for c in cols) else self._merge(self._parts)
        self.material = self._material(len(inputs.pos))
        self.gravity = torch.tensor(inputs.gravity, dtype=dtype, device=device)

    def _t(self, x):
        return torch.as_tensor(np.asarray(x, np.float64), device=self.device).to(self.dtype)

    def _stated_pose(self, c):
        """The pose that the configuration states for collider c (float64)."""
        rot = torch.tensor([body_ref.quaternion(self.inputs.dim, c.rotation)],
                           dtype=torch.float64)
        return (np.asarray(c.translation, np.float64),
                body_ref.rotation_matrix(rot)[0].numpy())

    def _part(self, c, pose):
        """Collider c's node CDF at a pose, by its kind's part."""
        return scene.load_part("colliders", c.kind).node_cdf(c, pose, self.grid, self.dtype,
                                                             self.device)

    def _merge(self, parts) -> Colliders:
        """The colliders' node CDFs merged: per node the nearest collider
        (the lowest slot on a tie) is the closest; bit c where collider c
        reaches the node, bit 16 + c where the node lies below it."""
        dists = torch.stack([d for d, _, _ in parts])              # [C, M]
        dist = dists.min(0).values
        slot = torch.arange(len(parts), device=self.device)[:, None]
        hit = torch.isfinite(dist) & (dists == dist)
        closest = torch.where(hit, slot, len(parts)).min(0).values
        closest = torch.where(closest == len(parts), -1, closest)
        aff = torch.zeros_like(closest)
        for c, (_, has, below) in enumerate(parts):
            aff = aff | (has.long() << c) | (below.long() << (16 + c))
        return Colliders(dist, closest, aff, len(parts))

    def _colliders(self, bodies: dict) -> Colliders:
        """The node CDF at the bodies' poses: the fixed colliders' parts
        kept, each kinematic collider's at its pose in `bodies`."""
        if self.colliders is not None:
            return self.colliders
        return self._merge([p if p is not None else self._part(c, body_ref.pose(bodies, i))
                            for i, (c, p) in enumerate(zip(self.inputs.colliders,
                                                           self._parts))])

    def _material(self, n: int) -> Material:
        mat, d, h = self.inputs.material, self.inputs.dim, self.inputs.h

        def lame(e, nu):
            return e * nu / ((1 + nu) * (1 - 2 * nu)), e / (2 * (1 + nu))

        full = lambda v: torch.full((n,), float(v), dtype=self.dtype, device=self.device)  # noqa: E731
        vol0 = (2.0 * mat["radius_cells"] * h) ** d
        lam, mu = lame(mat["young_modulus"], mat["poisson_ratio"])
        dp = None
        if mat["plasticity"] is not None:
            p = mat["plasticity"]
            dlam, dmu = lame(p["young_modulus"], p["poisson_ratio"])
            dp = {"h0": full(math.radians(p["h0_deg"])), "h1": full(math.radians(p["h1_deg"])),
                  "h2": full(p["h2"]), "h3": full(math.radians(p["h3_deg"])),
                  "lam": full(dlam), "mu": full(dmu)}
        return Material(mass=full(vol0 * mat["density"]), vol0=full(vol0), lam=full(lam),
                        mu=full(mu), stretch=full(mat["max_stretch"]), dp=dp)

    def initial(self) -> dict:
        """The state the inputs give: particles at rest, F = I, no affinity,
        the plastic state (1, 1, 0), the material's phase; the bodies as
        the configuration states them."""
        n, d = self.inputs.pos.shape
        z = torch.zeros((n, d), dtype=self.dtype, device=self.device)
        full = lambda v: torch.full((n,), float(v), dtype=self.dtype, device=self.device)  # noqa: E731
        m = self.material
        return {
            "ids": torch.arange(n, device=self.device),
            "pos": self._t(self.inputs.pos), "vel": z,
            "F": torch.eye(d, dtype=self.dtype, device=self.device).expand(n, d, d).clone(),
            "affine": torch.zeros((n, d, d), dtype=self.dtype, device=self.device),
            "aff": torch.zeros(n, dtype=torch.long, device=self.device),
            "phase": full(self.inputs.material["phase"]),
            "dps": {"det": full(1.0), "hardening": full(1.0), "log_vol_gain": full(0.0)},
            "mass": m.mass, "vol0": m.vol0, "lam": m.lam, "mu": m.mu,
            "dp": m.dp, "stretch": m.stretch,
            "bodies": body_ref.initial(self.inputs.colliders, d, self.dtype, self.device),
        }

    def _material_of(self, idx) -> Material:
        m = self.material
        return Material(mass=m.mass[idx], vol0=m.vol0[idx], lam=m.lam[idx], mu=m.mu[idx],
                        stretch=m.stretch[idx],
                        dp=None if m.dp is None else {k: v[idx] for k, v in m.dp.items()})

    def _dynamic(self, st: dict) -> dict:
        dt = self.dtype
        return {"pos": st["pos"].to(dt), "vel": st["vel"].to(dt), "F": st["F"].to(dt),
                "affine": st["affine"].to(dt), "aff": st["aff"],
                "phase": st["phase"].to(dt),
                "dps": {k: v.to(dt) for k, v in st["dps"].items()},
                "bodies": {k: v.to(dt) for k, v in st["bodies"].items()}}

    def _step(self, cur: dict, mat: Material) -> dict:
        """One substep of the particles against the colliders at the
        bodies' poses, then the kinematic bodies advanced."""
        b = cur["bodies"]
        out = substep(cur, mat, self._colliders(b), b, self.grid, self.inputs.dt,
                      self.gravity)
        out["bodies"] = body_ref.advance(b, self.kinematic, self.inputs.dt)
        return out

    def frame(self, st: dict, every: bool = False):
        """One frame of the configuration's substeps from st (the program's
        dynamic state: pos, vel, F, affine, aff, phase, dps, bodies, ids);
        the constants are the reference's own (each state carries its
        masses).  With `every`, the list of the states after each
        substep."""
        cur = self._dynamic(st)
        mat = self._material_of(st["ids"])
        out = []
        for _ in range(self.inputs.substeps):
            cur = self._step(cur, mat)
            cur["ids"], cur["mass"] = st["ids"], mat.mass
            out.append(cur)
        return out if every else out[-1]

    def substep(self, st: dict) -> dict:
        """One substep from st, in this reference's dtype."""
        mat = self._material_of(st["ids"])
        out = self._step(self._dynamic(st), mat)
        out["ids"], out["mass"] = st["ids"], mat.mass
        return out
