"""The PyTorch port's main path against the independent numpy CPIC oracle
(tests/oracle_cpic.py), as test_cpic_oracle.py::test_vs_oracle_cpic_pallas
holds the JAX kernel path: a sand/elastic block on a static floor pushed
by a kinematic wall, without and with the oracle scene's dynamic plate
(two-way coupled, no body contacts, as the JAX package's test runs it)."""

import numpy as np
import torch
from oracle_cpic import Body, OracleCpic

from wgsparkl_tpu_torch.collision.shapes import Collider
from wgsparkl_tpu_torch.grid import GridConfig
from wgsparkl_tpu_torch.models import ElasticCoefficients
from wgsparkl_tpu_torch.models.drucker_prager import DruckerPrager, drucker_prager_arrays
from wgsparkl_tpu_torch.params import SimulationParams
from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc, step_pallas
from wgsparkl_tpu_torch.solver import Models, Particles


DT = 1e-3
STEPS = 12


def _run(plate: bool):
    """The oracle scene through STEPS substeps of the port and of the
    oracle: (port state, oracle, oracle bodies)."""
    rng = np.random.default_rng(3)
    cw = 0.5
    xs = np.arange(8) * 0.25 - 1.0
    ys = np.arange(5) * 0.25 + 0.15
    zs = np.arange(6) * 0.25 - 0.7
    pos = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)
    pos = (pos + rng.uniform(-0.02, 0.02, pos.shape)).astype(np.float32)
    n = len(pos)
    phase = (pos[:, 0] > 0.0).astype(np.float32)
    elast = ElasticCoefficients.from_young_modulus(5.0e5, 0.2)
    dpm = drucker_prager_arrays([DruckerPrager.new(5.0e5, 0.2)])
    dp = {k: np.full(n, v[0]) for k, v in dpm.items()}
    bodies = [
        RigidBodyDesc(Collider.cuboid(4.0, 0.5, 4.0), (0.0, -0.5, 0.0)),
        RigidBodyDesc(Collider.cuboid(0.25, 1.5, 2.0), (-1.6, 1.0, 0.0),
                      body_type="kinematic", linvel=(0.4, 0.0, 0.0)),
    ]
    obodies = [Body((4.0, 0.5, 4.0), (0.0, -0.5, 0.0)),
               Body((0.25, 1.5, 2.0), (-1.6, 1.0, 0.0), linvel=(0.4, 0.0, 0.0))]
    if plate:
        bodies.append(RigidBodyDesc(Collider.cuboid(0.5, 0.25, 0.5), (0.4, 1.72, -0.2),
                                    body_type="dynamic", density=400.0))
        obodies.append(Body((0.5, 0.25, 0.5), (0.4, 1.72, -0.2), density=400.0))
    data = MpmData(
        SimulationParams.new(DT, [0.0, -9.81, 0.0], device="cpu"),
        Particles.from_arrays(pos, density=1200.0, radius=cw / 4, device="cpu"),
        Models.from_arrays(n, elast.lam, elast.mu, dp=dp, phase=phase,
                           device="cpu"),
        bodies, cw,
        grid=GridConfig.from_bounds(np.array([-4.0, -2.0, -4.0]),
                                    np.array([4.0, 4.0, 4.0]), cw),
        group=64, by=4, body_contacts=False)
    assert data.config.static_slots == (0,) and data.config.dynamic_slots == ()
    p, m = data.state.particles, data.state.models
    g = data.config.grid
    oracle = OracleCpic(
        p.pos.numpy(), p.vel.numpy(), p.mass.numpy(), p.init_volume.numpy(),
        m.lam.numpy(), m.mu.numpy(), g.cell_width, g.origin_cell, g.shape,
        dp=dp, phase=phase, bodies=obodies)
    state = data.state
    for _ in range(STEPS):
        state = step_pallas(state, data.params, data.config, 1)
        oracle.step(DT, data.params.gravity.numpy())
    order = torch.argsort(state.particles.ids).numpy()
    sp = state.particles
    np.testing.assert_allclose(sp.pos.numpy()[order], oracle.p, atol=5e-5)
    np.testing.assert_allclose(sp.vel.numpy()[order], oracle.v, atol=1e-3)
    np.testing.assert_allclose(sp.def_grad.numpy()[order], oracle.F, atol=5e-4)
    np.testing.assert_array_equal(
        sp.cdf_affinity.numpy().view(np.uint32)[order], oracle.aff.astype(np.uint32))
    np.testing.assert_allclose(sp.cdf_signed_distance.numpy()[order], oracle.sd,
                               atol=5e-4)
    np.testing.assert_allclose(state.bodies.pos.numpy()[1], obodies[1].pos,
                               atol=1e-6)
    return state, oracle, obodies


def test_step_pallas_matches_cpic_oracle():
    _, oracle, _ = _run(plate=False)
    # Both colliders (the static floor, the moving wall) touched the sand.
    aff = oracle.aff.astype(np.uint32)
    assert (aff & 1).any() and (aff & 2).any()


def test_step_pallas_with_dynamic_plate_matches_cpic_oracle():
    """The dynamic plate on the sand, moved by the CPIC impulses and
    gravity: its pose and velocities within the JAX package's test's
    tolerances (tests/test_cpic_oracle.py::test_vs_oracle_cpic_pallas)."""
    state, _, obodies = _run(plate=True)
    b = state.bodies
    np.testing.assert_allclose(b.pos.numpy()[2], obodies[2].pos, atol=1e-5)
    np.testing.assert_allclose(b.linvel.numpy()[2], obodies[2].linvel, atol=1e-4)
    np.testing.assert_allclose(b.angvel.numpy()[2], obodies[2].angvel, atol=1e-4)
    assert np.linalg.norm(obodies[2].linvel) > 1e-6
