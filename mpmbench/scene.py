"""The general scene generator: a configuration file and a traffic file,
read by name, and a seed give the inputs of one run, which the program's
builder (mpmbench/program.py) and the reference (mpmbench/reference/) both
take.

A configuration (configs/<name>.json) states the scene as it is run: the
dimension, cell width, substeps a frame, the lattice of particles (counts,
spacing, horizontal origin), the material, the colliders, gravity, the
grid's bounds, the transfer and the job table's group (and, where an
integer, its max_jobs).  Each collider names its kind; the kind's parts
are files of their own, found by that name: colliders/<kind>.py makes the
collider's inputs from its entry and the seed and gives the reference its
node CDF at a pose, and program_colliders/<kind>.py gives the program's
shape.  A collider's body is fixed (the default) or kinematic: the
optional keys `rotation` (a scaled axis in 3D, an angle in 2D),
`body_type`, `linvel` and `angvel` state its pose and, kinematic, the
velocities it keeps.  A dynamic body is refused: the reference has no
rigid solve.  A traffic file (traffic/<name>.json) states how the window
drives it: the entry (entries/<entry>.py) and the substeps of one call of
it, the frames of the replayed episode, the lattice's height (its drop
onto the colliders) and the seeded jitter.  The seed draws the jitter of
every particle, at most `jitter` particle spacings on each axis, and what
a collider kind draws (a heightfield's noise); it changes no size.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Optional

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent


BODY_TYPES = ("fixed", "kinematic")


@dataclasses.dataclass
class Collider:
    """A collider: its kind, its body's pose (translation; rotation as a
    scaled axis in 3D, an angle in 2D, None for the identity), its body
    type and, kinematic, its linear and angular velocity (None: zero), and
    the inputs that colliders/<kind>.py made (in the body's frame).
    `cache` holds what a kind's part keeps between calls (a mesh's samples
    in the body's frame)."""

    kind: str
    translation: tuple
    data: dict
    rotation: object = None
    body_type: str = "fixed"
    linvel: Optional[tuple] = None
    angvel: object = None
    cache: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def kinematic(self) -> bool:
        return self.body_type == "kinematic"


def collider(entry: dict, rng) -> Collider:
    """A configuration's collider entry as a Collider, its kind's inputs
    drawn from rng."""
    body_type = entry.get("body_type", "fixed")
    if body_type == "dynamic":
        raise ValueError("mpmbench: a dynamic body needs a rigid solve in the reference, "
                         "which it does not have; give the collider body_type 'fixed' "
                         "or 'kinematic'")
    if body_type not in BODY_TYPES:
        raise ValueError(f"mpmbench: body_type {body_type!r} is not one of {BODY_TYPES}")
    vel = {k: entry.get(k) for k in ("linvel", "angvel")}
    if body_type == "fixed" and any(v is not None and np.any(v) for v in vel.values()):
        raise ValueError("mpmbench: a fixed body has no velocity; make it kinematic")
    tup = lambda v: None if v is None else tuple(np.atleast_1d(v).tolist())  # noqa: E731
    rot = entry.get("rotation")
    return Collider(entry["kind"], tuple(entry["translation"]),
                    load_part("colliders", entry["kind"]).make(entry, rng),
                    rotation=rot if rot is None or np.ndim(rot) == 0 else tuple(rot),
                    body_type=body_type, linvel=tup(vel["linvel"]),
                    angvel=tup(vel["angvel"]))


@dataclasses.dataclass
class Inputs:
    config: dict
    traffic: dict
    seed: int
    dim: int
    h: float
    dt: float
    gravity: np.ndarray
    substeps: int
    pos: np.ndarray               # [N, d] f32
    colliders: list
    grid_lo: np.ndarray
    grid_hi: np.ndarray

    @property
    def material(self) -> dict:
        return self.config["material"]


def load(kind: str, name: str) -> dict:
    """configs/<name>.json or traffic/<name>.json."""
    return json.loads((ROOT / kind / f"{name}.json").read_text())


_PARTS = {}


def load_part(folder: str, name: str):
    """The module <folder>/<name>.py of the benchmark (a metric's reader, a
    collider kind's part, an entry), found by name."""
    key = (folder, name)
    if key not in _PARTS:
        path = ROOT / folder / f"{name}.py"
        if not path.is_file():
            raise ValueError(f"mpmbench: no {folder}/{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"mpmbench_{folder}_{name}".replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _PARTS[key] = mod
    return _PARTS[key]


def _rng(seed: int, stream: int):
    return np.random.default_rng([stream, int(seed) & (2 ** 64 - 1)])


def _lattice(counts, spacing, origin):
    axes = [(np.arange(c, dtype=np.float64) + 0.5) * spacing + o
            for c, o in zip(counts, origin)]
    return np.stack([g.ravel() for g in np.meshgrid(*axes, indexing="ij")], -1)


def make(config: dict, traffic: dict, seed: int) -> Inputs:
    """The inputs of one run."""
    d = config["dim"]
    h = float(config["cell_width"])
    lat = config["lattice"]
    spacing = h / lat["per_cell"]
    origin = list(lat["origin"])
    origin[1] = traffic["lattice_bottom"]
    pos = _lattice(lat["counts"], spacing, origin)
    jit = traffic["jitter"] * spacing
    pos = pos + _rng(seed, 1).uniform(-jit, jit, pos.shape)
    # Collider i draws from stream 2 + i of the seed.
    colliders = [collider(c, _rng(seed, 2 + i)) for i, c in enumerate(config["colliders"])]
    substeps = config["substeps"]
    dt = float(np.float32(1.0 / config["frame_rate"] / substeps))
    return Inputs(config=config, traffic=traffic, seed=seed, dim=d, h=h, dt=dt,
                  gravity=np.asarray(config["gravity"], np.float64), substeps=substeps,
                  pos=pos.astype(np.float32), colliders=colliders,
                  grid_lo=np.asarray(config["grid_bounds"][0], np.float64),
                  grid_hi=np.asarray(config["grid_bounds"][1], np.float64))

