"""An elastic block falling onto three thin trimesh blades and being cut
(examples/elastic_cut3.py on the port): a max(10, 50 SCALE) x
max(6, 30 SCALE) x max(10, 50 SCALE) lattice with fracture (max_stretch
1.3), gravity x4, 20 substeps a frame.

    python -m wgsparkl_tpu_torch.examples.elastic_cut3
"""

import numpy as np

from wgsparkl_tpu_torch.collision.shapes import Collider
from wgsparkl_tpu_torch.examples import common
from wgsparkl_tpu_torch.models import ElasticCoefficients
from wgsparkl_tpu_torch.params import SimulationParams
from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc
from wgsparkl_tpu_torch.scenes import _lattice
from wgsparkl_tpu_torch.solver import Models, Particles


def blade(cx, angle, half_len, height=6.0):
    """A vertical rectangle of two triangles, turned by `angle` about y and
    standing at (cx, 2, 0)."""
    v = np.array([[-half_len, 0, 0], [half_len, 0, 0], [half_len, height, 0],
                  [-half_len, height, 0]], np.float32)
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    v = v @ rot.T + np.array([cx, 2.0, 0.0], np.float32)
    return Collider.trimesh(v, np.array([[0, 1, 2], [0, 2, 3]], np.int32))


def build(scale: float = 0.3, device=None, transfer: str = "pallas", group: int = 256,
          **mpm_kw):
    cell_width = 1.0
    nx = max(10, int(50 * scale))
    nyz = max(6, int(30 * scale))
    pos = _lattice((nx, nyz, nx), cell_width,
                   (-nx * cell_width / 4, 14.0, -nx * cell_width / 4))
    n = len(pos)
    particles = Particles.from_arrays(pos, density=1000.0, radius=cell_width / 4,
                                      device=device)
    elast = ElasticCoefficients.from_young_modulus(1e7, 0.2)
    models = Models.from_arrays(n, elast.lam, elast.mu, phase=1.0, max_stretch=1.3,
                                device=device)
    extent = nx * cell_width
    bodies = [
        RigidBodyDesc(Collider.cuboid(extent * 3, 1.0, extent * 3), (0, -1.0, 0)),
        RigidBodyDesc(blade(-extent / 4, 0.4, extent), (0.0, 0.0, 0.0)),
        RigidBodyDesc(blade(0.0, -0.3, extent), (0.0, 0.0, 0.0)),
        RigidBodyDesc(blade(extent / 4, 0.1, extent), (0.0, 0.0, 0.0)),
    ]
    params = SimulationParams.new(dt=(1 / 60) / 20, gravity=[0.0, -9.81 * 4.0, 0.0],
                                  device=device)
    kw = {**common.transfer_kw(transfer, group), **mpm_kw}
    return MpmData(params, particles, models, bodies, cell_width,
                   grid_bounds=(np.array([-extent, -2.0, -extent]),
                                np.array([extent, 25.0, extent])),
                   **kw)


def main():
    data = build(common.scale(0.3), common.device(), **common.env_kw())
    print(f"elastic_cut3: {data.num_particles} particles, "
          f"{data.state.meshes.count} rigid samples")
    tb = common.run_example(data, num_substeps=20, frames=40, name="elastic_cut3")
    phase = tb.data.state.models.phase
    print(f"fractured particles: {float((phase == 0).float().mean()) * 100:.1f}%")


if __name__ == "__main__":
    main()
