"""The port's step_pallas on tests/test_sparse_domain.py's mesh scene (the
trimesh ramp and cuboid floor, test_sparse_mesh_colliders_match_bounded)
against the JAX package's, both sparse, over 12 substeps in one frame:
every substep builds the slot channel grid of the cuboid's analytic node
CDF and the slot-addressed mesh pass.  Tolerances: the mesh slice's
(tests/torch_mesh_scenes.compare_slice: positions 5e-5, velocities 1e-3,
affinity words exact, body poses 1e-6); the port's own bounded run of the
scene agrees with its sparse run likewise (the JAX test's comparison)."""

import numpy as np
import torch

import torch_mesh_scenes as M
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch.pipeline import step_pallas

torch.set_num_threads(2)


def test_sparse_ramp_matches_jax():
    jd = M.ramp(4, sparse=True)
    assert jd.config.sparse and jd.config.mesh_cids == (0,)
    ref, out = M.run_both(jd, 12)
    M.compare_slice(ref, out)
    aff = out.particles.cdf_affinity.numpy()
    assert (aff & 1).any(), "no particle's affinity names the mesh slot"
    bounded = M.ramp(4)
    bcfg = interop.config_from_reference(bounded.config)
    bout = step_pallas(interop.state_from_reference(bounded.state, "cpu"),
                       interop.params_from_reference(bounded.params, "cpu"), bcfg, 12)
    ib, is_ = np.argsort(bout.particles.ids.numpy()), np.argsort(out.particles.ids.numpy())
    np.testing.assert_allclose(out.particles.pos.numpy()[is_],
                               bout.particles.pos.numpy()[ib], rtol=0, atol=5e-5)
    np.testing.assert_allclose(out.particles.vel.numpy()[is_],
                               bout.particles.vel.numpy()[ib], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(out.particles.cdf_affinity.numpy()[is_],
                                  bout.particles.cdf_affinity.numpy()[ib])
