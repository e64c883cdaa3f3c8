"""2D sand with static, kinematic and dynamic colliders (examples/sand2.py
on the port): a max(48, 700 SCALE)^2 lattice, floor and walls, three
kinematic stirrers and two dynamic plates of different densities (two-way
coupling), 10 substeps a frame.

    python -m wgsparkl_tpu_torch.examples.sand2
"""

import numpy as np

from wgsparkl_tpu_torch.collision.shapes import Collider
from wgsparkl_tpu_torch.examples import common
from wgsparkl_tpu_torch.models import DruckerPrager, ElasticCoefficients
from wgsparkl_tpu_torch.models.drucker_prager import drucker_prager_arrays
from wgsparkl_tpu_torch.params import SimulationParams
from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc
from wgsparkl_tpu_torch.scenes import _lattice
from wgsparkl_tpu_torch.solver import Models, Particles


def build(scale: float = 0.2, device=None, transfer: str = "pallas", group: int = 256,
          **mpm_kw):
    n_side = max(48, int(700 * scale))
    cell_width = 0.2
    pos = _lattice((n_side, n_side), cell_width, (0.1, 46.0 * scale + 2.0))
    n = len(pos)
    particles = Particles.from_arrays(pos, density=1000.0, radius=cell_width / 4,
                                      device=device)
    elast = ElasticCoefficients.from_young_modulus(1e7, 0.2)
    dp = drucker_prager_arrays([DruckerPrager.new(1e7, 0.2)])
    dp = {k: np.full(n, v[0]) for k, v in dp.items()}
    models = Models.from_arrays(n, elast.lam, elast.mu, dp=dp, device=device)
    extent = n_side * cell_width / 2
    bodies = [
        # floor and walls
        RigidBodyDesc(Collider.cuboid(extent * 4, 1.0), (extent / 2, -1.0)),
        RigidBodyDesc(Collider.cuboid(1.0, extent * 4), (-extent * 1.2, 0.0)),
        RigidBodyDesc(Collider.cuboid(1.0, extent * 4), (extent * 2.2, 0.0)),
        # kinematic stirrers
        RigidBodyDesc(Collider.cuboid(extent * 0.3, 0.4), (extent * 0.5, extent * 0.5),
                      body_type="kinematic", angvel=1.0),
        RigidBodyDesc(Collider.ball(extent * 0.15), (extent * 1.0, extent * 0.8),
                      body_type="kinematic", angvel=1.0),
        RigidBodyDesc(Collider.capsule(extent * 0.2, extent * 0.08),
                      (extent * 0.2, extent * 0.9), body_type="kinematic", angvel=-1.0),
        # dynamic plates of different densities (two-way coupling)
        RigidBodyDesc(Collider.cuboid(extent * 0.15, 0.3), (extent * 0.4, extent * 1.6),
                      body_type="dynamic", density=500.0),
        RigidBodyDesc(Collider.cuboid(extent * 0.15, 0.3), (extent * 0.9, extent * 1.8),
                      body_type="dynamic", density=2000.0),
    ]
    params = SimulationParams.new(dt=(1 / 60) / 10, gravity=[0.0, -9.81], device=device)
    kw = {**common.transfer_kw(transfer, group), **mpm_kw}
    return MpmData(params, particles, models, bodies, cell_width,
                   grid_bounds=(np.array([-extent * 1.6, -0.5]),
                                np.array([extent * 2.6, 60.0 * scale + extent * 1.5])),
                   **kw)


def main():
    data = build(common.scale(0.2), common.device(), **common.env_kw())
    print(f"sand2: {data.num_particles} particles, grid {data.config.grid.shape}")
    tb = common.run_example(data, num_substeps=10, frames=60, name="sand2")
    print("dynamic plate poses:", tb.data.state.bodies.pos[6:].tolist())


if __name__ == "__main__":
    main()
