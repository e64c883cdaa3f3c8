"""The numbers that decide `correct`: the program's state against the
reference's.  A cell compares the numbers that its limits/<cell>.json
lists, each against its own limit; a number that separates no fault from
sound runs in a cell (no particle of an elastic block has a plastic state;
no grain of sand fractures) is left out of that cell's file.

  start_gap  the program's initial state against the one the reference
             derives from the same inputs: the largest relative gap of a
             constant (mass, volume, Lame and Drucker-Prager parameters,
             fracture threshold) and absolute gap of a dynamic field
             (position in cells, velocity, F, affine matrix, phase, plastic
             state, the bodies as body_gap measures them);
  pos_gap    over the compared frames, the largest gap of a particle's
             position after the frame, in cells;
  vel_gap    the same of its velocity, in cells a substep (v dt / h);
  F_gap      the same of an entry of its deformation gradient;
  affine_gap the same of an entry of its affine matrix (the velocity
             gradient and stress term of the last G2P and update) times
             dt over the particle's mass (the reference's): the velocity
             that the gap adds at one cell's distance in P2G, in cells a
             substep;
  dps_gap    the same of its Drucker-Prager state (det, hardening, log of
             the volume gain);
  phase_flips  the particles whose phase (1 elastic, 0 failed: fracture)
             differs from the reference's;
  aff_flips  the particles whose collider affinity word (bit c: near
             collider c, bit 16 + c: on its negative side) differs;
  body_gap   over the compared frames, the largest gap between the
             program's bodies after the frame and the reference's
             (reference/bodies.gap): position in cells, an entry of the
             rotation matrix, linear velocity in cells a substep, angular
             velocity times dt.  A fixed body keeps its state exactly on
             both sides, so a cell of fixed bodies reads 0 and its limit
             is 0.

A compared frame starts from the program's own state before it (the
reference follows the program frame by frame: its F and contact state
amplify roundoff over longer spans).
"""

from __future__ import annotations

import torch

from mpmbench.reference import bodies

NUMBERS = ("start_gap", "pos_gap", "vel_gap", "F_gap", "affine_gap", "dps_gap",
           "phase_flips", "aff_flips", "body_gap")


def _by_id(st: dict, key: str):
    return st[key][torch.argsort(st["ids"])]


def _gap(a, b):
    return float((a - b).abs().max()) if a.numel() else 0.0


def _rel(a, b):
    return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max()) if a.numel() else 0.0


def start_gap(prog: dict, ref: dict, h: float, dt: float) -> float:
    """The program's initial state (program.read_state) against the
    reference's (Reference.initial)."""
    g = [_gap(_by_id(prog, "pos"), _by_id(ref, "pos")) / h]
    for k in ("vel", "F", "affine", "phase"):
        g.append(_gap(_by_id(prog, k), _by_id(ref, k)))
    for k in ("det", "hardening", "log_vol_gain"):
        g.append(_gap(prog["dps"][k][torch.argsort(prog["ids"])],
                      ref["dps"][k][torch.argsort(ref["ids"])]))
    for k in ("mass", "vol0", "lam", "mu", "stretch"):
        g.append(_rel(_by_id(prog, k), _by_id(ref, k).to(torch.float64)))
    if ref["dp"] is not None:
        for k, v in ref["dp"].items():
            g.append(_rel(prog["dp"][k][torch.argsort(prog["ids"])], v.to(torch.float64)))
    g.append(float((prog["aff"] != 0).sum()))
    g.append(bodies.gap(prog["bodies"], ref["bodies"], h, dt))
    return max(g)


def frame_gaps(post: dict, ref_post: dict, h: float, dt: float) -> dict:
    """The program's state after a frame (post) against the reference's
    frame from the program's state before it (ref_post)."""
    d = lambda k: _gap(_by_id(post, k), _by_id(ref_post, k).to(torch.float64))  # noqa: E731
    prog_order, ref_order = torch.argsort(post["ids"]), torch.argsort(ref_post["ids"])
    dps = max(_gap(post["dps"][k][prog_order], ref_post["dps"][k][ref_order].to(torch.float64))
              for k in ("det", "hardening", "log_vol_gain"))
    flips = lambda k: float((post[k][prog_order] != ref_post[k][ref_order].to(  # noqa: E731
        post[k].dtype)).sum())
    mass = ref_post["mass"][ref_order].to(torch.float64)[:, None, None]
    affine = _gap(post["affine"][prog_order] / mass,
                  ref_post["affine"][ref_order].to(torch.float64) / mass) * dt
    return {"pos_gap": d("pos") / h, "vel_gap": d("vel") * dt / h, "F_gap": d("F"),
            "affine_gap": affine, "dps_gap": dps,
            "phase_flips": flips("phase"), "aff_flips": flips("aff"),
            "body_gap": bodies.gap(post["bodies"], ref_post["bodies"], h, dt)}


def worst(values: dict, new: dict) -> dict:
    """values with each of new's numbers taken where larger; a number that
    is not finite (NaN) stays: it fails."""
    out = dict(values)
    for k, v in new.items():
        old = out.get(k)
        out[k] = v if old is None or v != v or (old == old and v > old) else old
    return out


def judge(values: dict, limits: dict) -> bool:
    """Every number the cell's limits list at or under its limit (a number
    that is not finite fails)."""
    return all(values[k] == values[k] and values[k] <= lim for k, lim in limits.items())
