"""The ballistic spray of tests/test_sparse_domain.py
(test_particles_travel_beyond_initial_bounds) in the port against the JAX
package, both sparse and collider-free (kernel F), over 40 substeps: the
particles fly far past the nominal grid, which the sparse domain ignores
but for its cell width and origin.  Each substep starts both packages from
the JAX state and is held to tests/torch_port_helpers.compare_states
(positions 1e-5, velocities 1e-4, F 1e-4, affinity words all zero, the
inert body slot exact): a substep agrees to 1e-6 in position, but chained
the packages' roundoff adds up at these speeds (12 m/s, 2e-2 s substeps)
to 3.6e-5 by the 37th.  Then the JAX test's own spread and motion checks
on the port's own 40-substep run."""

import numpy as np

from torch_port_helpers import _jax_step_pallas, compare_states
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch.pipeline import step_pallas
from wgsparkl_tpu.grid import GridConfig
from wgsparkl_tpu.models.drucker_prager import DruckerPrager, drucker_prager_arrays
from wgsparkl_tpu.models.elasticity import ElasticCoefficients
from wgsparkl_tpu.params import SimulationParams
from wgsparkl_tpu.pipeline import MpmData
from wgsparkl_tpu.solver import Models, Particles


def _spray() -> MpmData:
    rng = np.random.default_rng(0)
    n_side = 6
    pos = np.stack(np.meshgrid(*([np.arange(n_side) * 0.5] * 3), indexing="ij"),
                   -1).reshape(-1, 3) + 1.0
    n = len(pos)
    vel = rng.normal(size=(n, 3)) * 12.0
    particles = Particles.from_arrays(pos.astype(np.float32), vel.astype(np.float32),
                                      density=1000.0, radius=0.25)
    elast = ElasticCoefficients.from_young_modulus(1.0e5, 0.2)
    dpm = drucker_prager_arrays([DruckerPrager.new(1.0e5, 0.2)])
    models = Models.from_arrays(n, elast.lam, elast.mu,
                                dp={k: np.full(n, v[0]) for k, v in dpm.items()})
    grid = GridConfig.from_bounds(np.zeros(3), np.full(3, 4.0), 0.5)
    params = SimulationParams.new(dt=2e-2, gravity=np.zeros(3))
    return MpmData(params, particles, models, [], 0.5, grid=grid, transfer="pallas",
                   group=64, job_chunk=8, sparse=True)


def test_sparse_spray_matches_jax():
    jd = _spray()
    cfg = interop.config_from_reference(jd.config)
    params = interop.params_from_reference(jd.params, "cpu")
    state, out = jd.state, interop.state_from_reference(jd.state, "cpu")
    for _ in range(40):
        ref = _jax_step_pallas(state, jd.params, jd.config, 1)
        compare_states(ref, step_pallas(interop.state_from_reference(state, "cpu"),
                                        params, cfg, 1), colliders=False)
        out = step_pallas(out, params, cfg, 1)
        state = ref
    p, v = out.particles.pos.numpy(), out.particles.vel.numpy()
    assert np.isfinite(p).all() and np.isfinite(v).all()
    pos0 = np.asarray(jd.state.particles.pos)
    spread = np.abs(p - pos0.mean(0)).max()
    assert spread > 8.0, spread
    g = jd.config.grid
    hi = (np.asarray(g.origin_cell) + np.asarray(g.shape)) * g.cell_width
    assert (p > hi).any(), "no particle left the nominal grid"
    assert (np.linalg.norm(v, axis=1) > 1.0).mean() > 0.9
    print(f"spray: spread {spread:.2f}, {int((p > hi).any(1).sum())} of {len(p)} "
          "particles past the nominal grid's high corner")
