"""3D mixed-material dam break, BASELINE config 3 (examples/dam_break3.py on
the port): a weakly compressible fluid column (corotated model with mu = 0,
which leaves only the lam J (J - 1) pressure term; E 1e6, nu 0.499) of
nf x 2 nf x nf particles, nf = max(8, int(40 SCALE)), collapsing against an
elastic block (E 1e6, nu 0.2) of ne^3, ne = max(6, int(20 SCALE)), in a
box of five static cuboids; by 8, group 1024, 20 substeps a frame (BY and
GROUP set them when run as a script).  At SCALE 1.25: 250,000 fluid and
15,625 elastic particles.  The script's default SCALE is 0.5 (17,000
particles), as the JAX example's:

    SCALE=1.25 python -m wgsparkl_tpu_torch.examples.dam_break3
"""

import numpy as np

from wgsparkl_tpu_torch.collision.shapes import Collider
from wgsparkl_tpu_torch.examples import common
from wgsparkl_tpu_torch.models import ElasticCoefficients
from wgsparkl_tpu_torch.params import SimulationParams
from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc
from wgsparkl_tpu_torch.scenes import _lattice
from wgsparkl_tpu_torch.solver import Models, Particles

SUBSTEPS = 20


def counts(scale: float):
    """(nf, ne): the fluid column's and the elastic block's side."""
    return max(8, int(40 * scale)), max(6, int(20 * scale))


def build(scale: float = 0.5, device=None, transfer: str = "pallas", group: int = 1024,
          by: int = 8, **mpm_kw):
    h = 1.0
    nf, ne = counts(scale)
    fluid_pos = _lattice((nf, 2 * nf, nf), h, (-nf * h / 2, 0.5, -nf * h / 2))
    elast_pos = _lattice((ne, ne, ne), h, (nf * h / 2 + 2.0, 0.5, -ne * h / 4))
    pos = np.concatenate([fluid_pos, elast_pos])
    n, nfp = len(pos), len(fluid_pos)
    particles = Particles.from_arrays(pos, density=1000.0, radius=h / 4, device=device)
    lam = np.empty(n, np.float32)
    mu = np.empty(n, np.float32)
    fl = ElasticCoefficients.from_young_modulus(1e6, 0.499)
    el = ElasticCoefficients.from_young_modulus(1e6, 0.2)
    lam[:nfp], mu[:nfp] = fl.lam, 0.0
    lam[nfp:], mu[nfp:] = el.lam, el.mu
    models = Models.from_arrays(n, lam, mu, phase=1.0, device=device)
    half = nf * h * 1.2
    bodies = [
        RigidBodyDesc(Collider.cuboid(half * 3, 1.0, half * 3), (0, -1.0, 0)),
        RigidBodyDesc(Collider.cuboid(0.5, half, half * 2), (-half, half, 0)),
        RigidBodyDesc(Collider.cuboid(0.5, half, half * 2), (half * 1.8, half, 0)),
        RigidBodyDesc(Collider.cuboid(half * 2, half, 0.5), (0, half, -half)),
        RigidBodyDesc(Collider.cuboid(half * 2, half, 0.5), (0, half, half)),
    ]
    params = SimulationParams.new(dt=(1 / 60) / SUBSTEPS, gravity=[0.0, -9.81, 0.0],
                                  device=device)
    kw = {"by": by, **common.transfer_kw(transfer, group), **mpm_kw}
    return MpmData(params, particles, models, bodies, h,
                   grid_bounds=(np.array([-half - 2, -2.0, -half - 2]),
                                np.array([half * 2 + 2, 2.2 * nf * h + 4, half + 2])),
                   **kw)


def main():
    scale = common.scale(0.5)
    data = build(scale, common.device(), **common.env_kw("BY"))
    n = data.num_particles
    nfp = 2 * counts(scale)[0] ** 3
    print(f"dam_break3: {n} particles ({nfp} fluid + {n - nfp} elastic), "
          f"grid {data.config.grid.shape}")
    common.run_example(data, num_substeps=SUBSTEPS, frames=40, name="dam_break3")


if __name__ == "__main__":
    main()
