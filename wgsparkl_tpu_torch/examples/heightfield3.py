"""Sand dropped on a random heightfield (examples/heightfield3.py on the
port): a max(8, 45 SCALE) x max(12, 100 SCALE) x max(8, 45 SCALE) lattice
over a rolling field of max(16, 48 SCALE)^2 heights (numpy default_rng(0)
noise), 20 substeps a frame.

    python -m wgsparkl_tpu_torch.examples.heightfield3
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


def build(scale: float = 0.35, device=None, transfer: str = "pallas", group: int = 256,
          **mpm_kw):
    cell_width = 1.0
    nxz = max(8, int(45 * scale))
    ny = max(12, int(100 * scale))
    pos = _lattice((nxz, ny, nxz), cell_width,
                   (-nxz * cell_width / 4, 16.0, -nxz * cell_width / 4))
    n = len(pos)
    particles = Particles.from_arrays(pos, density=2700.0, radius=cell_width / 4,
                                      device=device)
    elast = ElasticCoefficients.from_young_modulus(2e9, 0.2)
    dp = drucker_prager_arrays([DruckerPrager.new(2e9, 0.2)])
    dp = {k: np.full(n, v[0]) for k, v in dp.items()}
    models = Models.from_arrays(n, elast.lam, elast.mu, dp=dp, device=device)
    rng = np.random.default_rng(0)
    res = max(16, int(48 * scale))
    extent = nxz * cell_width * 1.5
    heights = 0.15 * np.sin(np.linspace(0, 6, res))[:, None] * np.cos(
        np.linspace(0, 6, res))[None, :] + 0.04 * rng.standard_normal((res, res))
    field = Collider.heightfield(heights, (2 * extent, 8.0, 2 * extent))
    params = SimulationParams.new(dt=(1 / 60) / 20, gravity=[0.0, -9.81, 0.0],
                                  device=device)
    kw = {**common.transfer_kw(transfer, group), **mpm_kw}
    return MpmData(params, particles, models, [RigidBodyDesc(field, (0.0, 0.0, 0.0))],
                   cell_width,
                   grid_bounds=(np.array([-extent, -6.0, -extent]),
                                np.array([extent, 30.0, extent])),
                   **kw)


def main():
    data = build(common.scale(0.35), common.device(), **common.env_kw())
    print(f"heightfield3: {data.num_particles} particles, "
          f"{data.state.meshes.count} rigid samples, grid {data.config.grid.shape}")
    common.run_example(data, num_substeps=20, frames=40, name="heightfield3")


if __name__ == "__main__":
    main()
