"""The port's step_pallas in the sparse, unbounded domain against the JAX
package's on tests/test_sparse_domain.py's sand box with its paddle, both
sparse and started from the same state, over 20 substeps.  Tolerances:
tests/torch_port_helpers.compare_states (positions 1e-5, velocities 1e-4,
F 1e-4, affinity words exact, bodies 1e-6).  The port's MpmData, built
from the JAX scene's arrays, must come to the JAX package's configuration
(kmax and amax defaults included)."""

import jax.numpy as jnp

from torch_port_helpers import compare_states, run_both
from wgsparkl_tpu import scenes
from wgsparkl_tpu.pipeline import MpmData


def _sparse_box(lower: float = 0.0, **kw) -> MpmData:
    """tests/test_sparse_domain.py's `_mk(sand_box_3d(nxz=8, ny=16),
    sparse=True, **kw)`, the lattice lowered by `lower` cells."""
    base = scenes.sand_box_3d(nxz=8, ny=16, cell_width=1.0)
    p = base.state.particles
    p = p.replace(pos=p.pos - jnp.asarray([0.0, lower, 0.0], jnp.float32))
    return MpmData(base.params, p, base.state.models,
                   base.bodies_desc, 1.0, grid=base.config.grid, transfer="pallas",
                   group=64, job_chunk=8, sparse=True, **kw)


def test_sparse_sand_box_matches_jax():
    jd = _sparse_box()
    assert (jd.config.kmax, jd.config.amax) == (jd.config.max_jobs, 4 * jd.config.max_jobs)
    ref, out = run_both(jd, 20)
    compare_states(ref, out)
