"""2D elastic block cut by thin polyline blades over a sine-wave ground
(examples/elastic_cut2.py on the port): a max(48, 700 SCALE)^2 lattice
with fracture (max_stretch 1.4), six blades, 15 substeps a frame.

    python -m wgsparkl_tpu_torch.examples.elastic_cut2
"""

import numpy as np

from wgsparkl_tpu_torch.collision.shapes import Collider
from wgsparkl_tpu_torch.examples import common
from wgsparkl_tpu_torch.models import ElasticCoefficients
from wgsparkl_tpu_torch.params import SimulationParams
from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc
from wgsparkl_tpu_torch.scenes import _lattice
from wgsparkl_tpu_torch.solver import Models, Particles


def _blade(cx, top, length):
    return Collider.polyline(np.array([[cx, top], [cx + 0.15, top - length]], np.float32))


def build(scale: float = 0.15, device=None, transfer: str = "pallas", group: int = 256,
          **mpm_kw):
    cell_width = 0.2
    n_side = max(48, int(700 * scale))
    pos = _lattice((n_side, n_side), cell_width, (0.1, 30.0 * scale))
    n = len(pos)
    particles = Particles.from_arrays(pos, density=1000.0, radius=cell_width / 4,
                                      device=device)
    elast = ElasticCoefficients.from_young_modulus(5e6, 0.2)
    models = Models.from_arrays(n, elast.lam, elast.mu, phase=1.0, max_stretch=1.4,
                                device=device)
    extent = n_side * cell_width / 2
    xs = np.linspace(-extent * 1.5, extent * 3.5, 64)
    ground = np.stack([xs, 0.4 * np.sin(xs * 0.8)], axis=-1)
    bodies = [RigidBodyDesc(Collider.polyline(ground), (0.0, -0.5))]
    for k in range(6):
        cx = extent * 0.2 + k * extent * 0.3
        bodies.append(RigidBodyDesc(_blade(cx, 30.0 * scale * 0.6, extent * 0.5),
                                    (0.0, 0.0)))
    params = SimulationParams.new(dt=(1 / 60) / 15, gravity=[0.0, -9.81 * 2],
                                  device=device)
    kw = {**common.transfer_kw(transfer, group), **mpm_kw}
    return MpmData(params, particles, models, bodies, cell_width,
                   grid_bounds=(np.array([-extent * 1.5, -2.0]),
                                np.array([extent * 3.5, 40.0 * scale + extent])),
                   **kw)


def main():
    data = build(common.scale(0.15), common.device(), **common.env_kw())
    print(f"elastic_cut2: {data.num_particles} particles, "
          f"{data.state.meshes.count} rigid samples")
    tb = common.run_example(data, num_substeps=15, frames=40, name="elastic_cut2")
    phase = tb.data.state.models.phase
    print(f"fractured: {float((phase == 0).float().mean()) * 100:.1f}%")


if __name__ == "__main__":
    main()
