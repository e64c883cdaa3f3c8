"""The collider-free slices of the PyTorch port (`step_pallas` with no body:
kernel F in 3D, kernels H and I at nc = 0 in 2D) against the JAX package
over 10 substeps of the spinning sand_box_3d(nxz=8, ny=16) lattice (by=8,
group=256) and sand_column_2d(nx=24, ny=48) lattice (group=128).

The 3D lattice carries elastic_blocks_2d's elastic models: with the sand's
Drucker-Prager models the jittered spin leaves particles at the cone tip
(F within 1e-4 of a rotation, trace of the log strain ~1e-7), where f32
roundoff picks the return map's branch.  There one particle's F differed
from the JAX package's by 1.28e-4 after a single substep from the same
state, and velocities by 6e-4 after 10 free-running substeps; with the JAX
kernel's P2G association in the port the same (4.7e-4)."""

import jax
import pytest

import torch_port_helpers as H
from wgsparkl_tpu.pipeline import step_pallas as j_step
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch.pipeline import step_with_diag

SUBSTEPS = 10
_j_step = jax.jit(j_step, static_argnums=(2, 3))


@pytest.mark.parametrize("dim", [3, 2])
def test_step_pallas_collider_free_matches_jax(dim):
    data = H.jax_scene_free(dim, elastic=dim == 3)
    assert data.config.num_colliders == 0
    ref = _j_step(data.state, data.params, data.config, SUBSTEPS)
    out, diag = step_with_diag(interop.state_from_reference(data.state, "cpu"),
                               interop.params_from_reference(data.params, "cpu"),
                               interop.config_from_reference(data.config),
                               SUBSTEPS)
    assert not diag.any_overflow()
    # Positions 1e-5, velocities and F 1e-4, affinity words all zero in
    # both, and the inert body slot to 1e-6 (it does not move at all).
    H.compare_states(ref, out, colliders=False)
    assert not out.bodies.pos.any() and not out.bodies.linvel.any()
