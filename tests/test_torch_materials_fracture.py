"""Several materials and fracture through the port's step_pallas against
the JAX package's pallas path on the CPU (the material table's lookups in
kernel C's plain version, its fracture check and the phase it writes).

  * the JAX package's three-material sand box
    (tests/test_materials.py::test_multi_material_pallas_matches_dense),
    10 substeps: particle state within compare_states' tolerances, every
    constant rebuilt from the table bit for bit;
  * four materials with fracture (max_stretch > 0 on three of them, phase
    1) in 3D (the 8 x 16 x 8 sand box lattice lowered 3 cells onto the
    paddle, spinning, max_stretch 1.0005) and in 2D (the 24 x 24 elastic
    blocks lowered 0.75 into the floor, 1.00005), 10 substeps, each started
    in both packages from the JAX package's state (the spinning start on
    the paddle amplifies roundoff from substep to substep): models.phase
    equal lane for lane after every substep, many lanes fractured.  In 3D
    max_stretch 1.00005 would put a cluster of 28 lanes of the first
    substep 2.7e-6 (23 f32 ulps) above the threshold, where the packages'
    SVD roundoff falls on either side; at 1.0005 no lane lies that near.
The dam break (mixed fluid and elastic models): tests/test_torch_dam_break.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from wgsparkl_tpu import scenes as jscenes
from wgsparkl_tpu.pipeline import MpmData

torch.set_num_threads(2)


def _by_id(state):
    return np.argsort(np.asarray(state.particles.ids))


def _three_materials():
    """tests/test_materials.py's _mixed_scene on the pallas path."""
    base = jscenes.sand_box_3d(nxz=8, ny=16, cell_width=1.0)
    p, m = base.state.particles, base.state.models
    stripe = np.arange(p.count) % 3
    lam, mu = np.asarray(m.lam).copy(), np.asarray(m.mu).copy()
    stretch = np.asarray(m.max_stretch).copy()
    lam[stripe == 1] *= 2.0
    mu[stripe == 2] *= 0.5
    stretch[stripe == 1] = 4.0
    m = m.replace(lam=jnp.asarray(lam), mu=jnp.asarray(mu),
                  max_stretch=jnp.asarray(stretch))
    return MpmData(base.params, p, m, base.bodies_desc, 1.0, grid=base.config.grid,
                   transfer="pallas", group=128, job_chunk=8)


def test_multi_material_pallas_matches_jax():
    jdata = _three_materials()
    assert jdata.config.n_materials == 3
    ref, out = H.run_both(jdata)
    H.compare_states(ref, out)
    ij, it = _by_id(ref), np.argsort(out.particles.ids.numpy())
    for got, want in ((out.models.lam, ref.models.lam),
                      (out.models.max_stretch, ref.models.max_stretch),
                      (out.particles.init_volume, ref.particles.init_volume)):
        np.testing.assert_array_equal(got.numpy()[it], np.asarray(want)[ij])


def _four_materials(models, n, stretch):
    """models with four materials striped by lane: lam x (1, 2, 1, 1.5), mu
    x (1, 1, 0.5, 1), max_stretch -1 on stripe 0 and `stretch` on the
    others, every lane intact (phase 1)."""
    stripe = np.arange(n) % 4
    lam = np.asarray(models.lam) * np.array([1.0, 2.0, 1.0, 1.5], np.float32)[stripe]
    mu = np.asarray(models.mu) * np.array([1.0, 1.0, 0.5, 1.0], np.float32)[stripe]
    stretch = np.where(stripe == 0, -1.0, stretch).astype(np.float32)
    return models.replace(lam=jnp.asarray(lam), mu=jnp.asarray(mu),
                          max_stretch=jnp.asarray(stretch),
                          phase=jnp.ones(n, jnp.float32))


def _fracture_scene(dim):
    if dim == 3:
        d = jscenes.sand_box_3d(nxz=8, ny=16, cell_width=1.0, with_paddle=True)
        p = d.state.particles
        p = p.replace(pos=p.pos + jnp.asarray([0.0, -3.0, 0.0], jnp.float32),
                      vel=jnp.asarray(H.spin_velocities(np.asarray(p.pos))))
        return MpmData(d.params, p, _four_materials(d.state.models, p.count, 1.0005),
                       d.bodies_desc, 1.0, grid=d.config.grid, transfer="pallas",
                       group=H.GROUP, job_chunk=8, by=H.BY)
    d = jscenes.elastic_blocks_2d(n_side=24, cell_width=0.5)
    p = d.state.particles
    p = p.replace(pos=p.pos + jnp.asarray([0.0, -0.75], jnp.float32))
    return MpmData(d.params, p, _four_materials(d.state.models, p.count, 1.00005),
                   d.bodies_desc, 0.5, grid=d.config.grid, transfer="pallas", group=H.GROUP_2D)


@pytest.mark.parametrize("dim", [2, 3])
def test_fracture_four_materials_phase_matches_jax(dim):
    jdata = _fracture_scene(dim)
    assert jdata.config.n_materials == 4

    def same_phase(ref, out):
        H.compare_states(ref, out)
        ij, it = _by_id(ref), np.argsort(out.particles.ids.numpy())
        np.testing.assert_array_equal(out.models.phase.numpy()[it],
                                      np.asarray(ref.models.phase)[ij])

    ref, out = H.run_both(jdata, each=same_phase)
    ij, it = _by_id(ref), np.argsort(out.particles.ids.numpy())
    phase = out.models.phase.numpy()[it]
    broken = int((phase == 0.0).sum())
    assert broken > (100 if dim == 3 else 50), broken
    # No lane of the material without fracture broke.
    stripe0 = (np.asarray(ref.particles.ids)[ij] % 4) == 0
    assert (phase[stripe0] == 1.0).all()
