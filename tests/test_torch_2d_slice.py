"""The 2D slice of the PyTorch port (`step_pallas` on the bounded grid,
8 x 8 blocks, every collider frame-static) against the JAX package over 10
substeps of both small 2D scenes: the sand column on its floor and the
elastic lattice between tilted walls."""

import jax
import pytest

import torch_port_helpers as H
from wgsparkl_tpu.pipeline import step_pallas as j_step
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch.pipeline import step_with_diag

SUBSTEPS = 10
_j_step = jax.jit(j_step, static_argnums=(2, 3))


@pytest.mark.parametrize("scene", H.SCENES_2D)
def test_step_pallas_2d_matches_jax(scene):
    data = H.jax_scene_2d(scene)
    ref = _j_step(data.state, data.params, data.config, SUBSTEPS)
    out, diag = step_with_diag(interop.state_from_reference(data.state, "cpu"),
                               interop.params_from_reference(data.params, "cpu"),
                               interop.config_from_reference(data.config),
                               SUBSTEPS)
    assert not diag.any_overflow()
    H.compare_states(ref, out)
