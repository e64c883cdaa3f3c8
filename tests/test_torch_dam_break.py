"""The 3D mixed-material dam break (examples/dam_break3.py, BASELINE config
3) at the example's smallest size through the port's step_pallas against
the JAX package's pallas path on the CPU: a weakly compressible fluid
column (corotated model, mu = 0) collapsing against an elastic block in a
box of five static cuboids, by=8.  10 substeps: particle state within
compare_states' tolerances, the two materials rebuilt from the table bit
for bit."""

import jax.numpy as jnp
import numpy as np
import torch

import torch_port_helpers as H
from wgsparkl_tpu.collision.shapes import Collider
from wgsparkl_tpu.models import ElasticCoefficients
from wgsparkl_tpu.params import SimulationParams
from wgsparkl_tpu.pipeline import MpmData, RigidBodyDesc
from wgsparkl_tpu.scenes import _lattice
from wgsparkl_tpu.solver import Models, Particles

torch.set_num_threads(2)


def _dam_break(nf=8, ne=6, h=1.0):
    """examples/dam_break3.py's scene with nf (fluid) and ne (elastic) as
    its smallest SCALE gives them; group 256."""
    fluid = _lattice((nf, 2 * nf, nf), h, (-nf * h / 2, 0.5, -nf * h / 2))
    block = _lattice((ne, ne, ne), h, (nf * h / 2 + 2.0, 0.5, -ne * h / 4))
    pos = np.concatenate([fluid, block])
    n, nfp = len(pos), len(fluid)
    lam, mu = np.empty(n, np.float32), np.empty(n, np.float32)
    fl = ElasticCoefficients.from_young_modulus(1e6, 0.499)
    el = ElasticCoefficients.from_young_modulus(1e6, 0.2)
    lam[:nfp], mu[:nfp] = fl.lam, 0.0
    lam[nfp:], mu[nfp:] = el.lam, el.mu
    half = nf * h * 1.2
    bodies = [
        RigidBodyDesc(Collider.cuboid(half * 3, 1.0, half * 3), (0, -1.0, 0)),
        RigidBodyDesc(Collider.cuboid(0.5, half, half * 2), (-half, half, 0)),
        RigidBodyDesc(Collider.cuboid(0.5, half, half * 2), (half * 1.8, half, 0)),
        RigidBodyDesc(Collider.cuboid(half * 2, half, 0.5), (0, half, -half)),
        RigidBodyDesc(Collider.cuboid(half * 2, half, 0.5), (0, half, half)),
    ]
    return MpmData(SimulationParams.new(dt=(1 / 60) / 20, gravity=[0.0, -9.81, 0.0]),
                   Particles.from_arrays(pos, density=1000.0, radius=h / 4),
                   Models.from_arrays(n, lam, mu, phase=1.0), bodies, h,
                   grid_bounds=(np.array([-half - 2, -2.0, -half - 2]),
                                np.array([half * 2 + 2, 2.2 * nf * h + 4, half + 2])),
                   by=8, transfer="pallas", group=256)


def test_dam_break_small_matches_jax():
    jdata = _dam_break()
    assert jdata.config.n_materials == 2 and jdata.config.by == 8
    ref, out = H.run_both(jdata)
    H.compare_states(ref, out)
    ij, it = np.argsort(np.asarray(ref.particles.ids)), np.argsort(out.particles.ids.numpy())
    for f in ("lam", "mu"):
        np.testing.assert_array_equal(getattr(out.models, f).numpy()[it],
                                      np.asarray(getattr(ref.models, f))[ij])
    # The column fell (10 kicks of gravity: 0.0818 m/s).
    assert float(jnp.abs(ref.particles.vel).max()) > 0.08
