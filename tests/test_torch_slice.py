"""The PyTorch port's main path (step_pallas on the coupled sand box with
the spinning paddle, by=8) against the JAX package's step_pallas, started
from the same state through interop, over 10 substeps."""

import jax

import torch_port_helpers as H
from wgsparkl_tpu.pipeline import step_pallas as j_step
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch.pipeline import step_with_diag


SUBSTEPS = 10
_j_step = jax.jit(j_step, static_argnums=(2, 3))


def test_step_pallas_matches_jax():
    data = H.jax_scene(H.SHIFTS["as_built"])
    ref = _j_step(data.state, data.params, data.config, SUBSTEPS)
    out, diag = step_with_diag(interop.state_from_reference(data.state, "cpu"),
                               interop.params_from_reference(data.params, "cpu"),
                               interop.config_from_reference(data.config),
                               SUBSTEPS)
    assert not diag.any_overflow()
    H.compare_states(ref, out)
