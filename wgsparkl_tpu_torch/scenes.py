"""Scene constructors (port of wgsparkl_tpu/scenes.py: `sand_box_3d`,
`elastic_blocks_2d`, `sand_column_2d`).  Each builds on `device`, the card
unless the caller asks for another (None: cuda:0).  `spin_velocities`
gives a lattice the rigid spin of the collider-free scenes."""

from __future__ import annotations

import numpy as np

from wgsparkl_tpu_torch.collision.shapes import Collider
from wgsparkl_tpu_torch.models import DruckerPrager, ElasticCoefficients
from wgsparkl_tpu_torch.models.drucker_prager import drucker_prager_arrays
from wgsparkl_tpu_torch.params import SimulationParams
from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc
from wgsparkl_tpu_torch.solver import Models, Particles


def _lattice(counts, cell_width, origin, spacing_div=2):
    axes = [(np.arange(c, dtype=np.float32) + 0.5) * (cell_width / spacing_div) + o
            for c, o in zip(counts, origin)]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=-1)


def spin_velocities(pos, jitter: float = 0.0, seed: int = 0) -> np.ndarray:
    """[N, d] f32 velocities of a rigid spin at 1 rad/s: omega = (0, -1, 0)
    (the paddle's) about the lattice's vertical centre line in 3D, -1 about
    its centre in 2D; plus numpy default_rng(seed) jitter uniform in
    [-jitter, jitter] m/s.  pos: [N, d] array-like."""
    pos = np.asarray(pos, np.float64)
    r = pos - 0.5 * (pos.min(0) + pos.max(0))
    v = np.zeros_like(pos)
    if pos.shape[1] == 3:
        v[:, 0], v[:, 2] = -r[:, 2], r[:, 0]
    else:
        v[:, 0], v[:, 1] = r[:, 1], -r[:, 0]
    if jitter:
        v += np.random.default_rng(seed).uniform(-jitter, jitter, size=pos.shape)
    return v.astype(np.float32)


def sand_box_3d(nxz: int = 45, ny: int = 100, cell_width: float = 1.0,
                num_substeps: int = 20, gravity_factor: float = 1.0,
                with_paddle: bool = True, device=None, **mpm_kw) -> MpmData:
    """3D Drucker-Prager sand in a box of five static walls, with an optional
    kinematic paddle spinning about y (the reference's sand3 example).
    mpm_kw go to MpmData, e.g. sparse=True, kmax=, amax= for the sparse
    domain."""
    pos = _lattice((nxz, ny, nxz), cell_width,
                   (-nxz * cell_width / 4, 10.0 * cell_width / 2,
                    -nxz * cell_width / 4))
    n = len(pos)
    particles = Particles.from_arrays(pos, density=2700.0, radius=cell_width / 4,
                                      device=device)
    elast = ElasticCoefficients.from_young_modulus(2.0e9, 0.2)
    dp = drucker_prager_arrays([DruckerPrager.new(2.0e9, 0.2)])
    dp = {k: np.full(n, v[0]) for k, v in dp.items()}
    models = Models.from_arrays(n, elast.lam, elast.mu, dp=dp, device=device)
    bodies = [
        RigidBodyDesc(Collider.cuboid(100.0, 4.0, 100.0), (0.0, -4.0, 0.0)),
        RigidBodyDesc(Collider.cuboid(35.0, 5.0, 0.5), (0.0, 5.0, -35.0)),
        RigidBodyDesc(Collider.cuboid(35.0, 5.0, 0.5), (0.0, 5.0, 35.0)),
        RigidBodyDesc(Collider.cuboid(0.5, 5.0, 35.0), (-35.0, 5.0, 0.0)),
        RigidBodyDesc(Collider.cuboid(0.5, 5.0, 35.0), (35.0, 5.0, 0.0)),
    ]
    if with_paddle:
        bodies.append(RigidBodyDesc(
            Collider.cuboid(0.5, 2.0, 30.0), (0.0, 2.0, 0.0),
            rotation=(0.0, 0.0, -0.5), body_type="kinematic",
            angvel=(0.0, -1.0, 0.0)))
    params = SimulationParams.new(dt=(1.0 / 60.0) / num_substeps,
                                  gravity=np.array([0.0, -9.81, 0.0]) * gravity_factor,
                                  device=device)
    half = nxz * cell_width / 2 + 10
    return MpmData(params, particles, models, bodies, cell_width,
                   grid_bounds=(np.array([-half, -2 * cell_width, -half]),
                                np.array([half, (ny + 30) * cell_width / 2, half])),
                   **mpm_kw)


def elastic_blocks_2d(n_side: int = 700, cell_width: float = 0.2,
                      num_substeps: int = 15, device=None, **mpm_kw) -> MpmData:
    """2D elastic lattice (E = 5e6) falling onto a floor between two walls
    tilted by +-0.4 rad (the reference's elasticity2 example)."""
    pos = _lattice((n_side, n_side), cell_width, (-n_side * cell_width / 4, 1.0))
    n = len(pos)
    particles = Particles.from_arrays(pos, density=1000.0, radius=cell_width / 4,
                                      device=device)
    elast = ElasticCoefficients.from_young_modulus(5.0e6, 0.2)
    models = Models.from_arrays(n, elast.lam, elast.mu, phase=1.0,
                                max_stretch=-1.0, device=device)
    extent = n_side * cell_width / 2
    bodies = [
        RigidBodyDesc(Collider.cuboid(extent * 4, 1.0), (0.0, -1.0)),
        RigidBodyDesc(Collider.cuboid(extent, 0.2), (-extent * 0.75, extent * 0.3),
                      rotation=0.4),
        RigidBodyDesc(Collider.cuboid(extent, 0.2), (extent * 0.75, extent * 0.3),
                      rotation=-0.4),
    ]
    params = SimulationParams.new(dt=(1.0 / 60.0) / num_substeps,
                                  gravity=[0.0, -9.81], device=device)
    return MpmData(params, particles, models, bodies, cell_width,
                   grid_bounds=(np.array([-extent * 2.5, -0.5]),
                                np.array([extent * 2.5, 1.5 + extent * 1.2])),
                   **mpm_kw)


def sand_column_2d(nx: int = 256, ny: int = 256, cell_width: float = 0.2,
                   num_substeps: int = 10, device=None, **mpm_kw) -> MpmData:
    """2D Drucker-Prager sand column collapsing on a flat floor (density
    1000, E = 1e7, nu = 0.2: the reference's sand2 example)."""
    pos = _lattice((nx, ny), cell_width, (-nx * cell_width / 4, cell_width))
    n = len(pos)
    particles = Particles.from_arrays(pos, density=1000.0, radius=cell_width / 4,
                                      device=device)
    elast = ElasticCoefficients.from_young_modulus(1.0e7, 0.2)
    dp = drucker_prager_arrays([DruckerPrager.new(1.0e7, 0.2)])
    dp = {k: np.full(n, v[0]) for k, v in dp.items()}
    models = Models.from_arrays(n, elast.lam, elast.mu, dp=dp, device=device)
    extent = max(nx, ny) * cell_width
    bodies = [RigidBodyDesc(Collider.cuboid(extent * 8, 1.0), (0.0, -1.0))]
    params = SimulationParams.new(dt=(1.0 / 60.0) / num_substeps,
                                  gravity=[0.0, -9.81], device=device)
    return MpmData(params, particles, models, bodies, cell_width,
                   grid_bounds=(np.array([-extent * 2, -0.2]),
                                np.array([extent * 2, extent * 1.5])),
                   **mpm_kw)
