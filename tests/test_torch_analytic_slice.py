"""The PyTorch port's 3D analytic-shapes slice against the JAX package:
step_pallas on the analytic-shapes scene (a static halfspace and four
walls, a kinematic capsule paddle and a kinematic ball) in the
gathered-hybrid and the chan-free CDF modes, the lattice lowered onto the
capsule and moved onto the ball.  Each substep starts both packages from
the JAX state: a penetrating start amplifies f32 roundoff from substep to
substep (tests/test_torch_slice_contact.py)."""

import jax
import pytest

import torch_port_helpers as H
from wgsparkl_tpu.pipeline import step_pallas as j_step
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch.pipeline import step_pallas


_j_step = jax.jit(j_step, static_argnums=(2, 3))


@pytest.mark.parametrize("scene", ["on_ball", "on_capsule"])
@pytest.mark.parametrize("chan_free", [False, True], ids=["gathered", "chan_free"])
def test_step_pallas_shapes_match_jax(chan_free, scene):
    data = H.jax_scene_shapes(H.SHIFTS_SHAPES[scene], chan_free)
    params = interop.params_from_reference(data.params, "cpu")
    cfg = interop.config_from_reference(data.config)
    # The port builds the same configuration from the same scene.
    assert cfg == H.port_data(data, chan_free=chan_free).config
    assert cfg.chan_free is chan_free and cfg.static_slots == (0, 1, 2, 3, 4)
    state = data.state
    for _ in range(2):
        ref = _j_step(state, data.params, data.config, 1)
        out = step_pallas(interop.state_from_reference(state, "cpu"), params, cfg, 1)
        H.compare_states(ref, out)
        state = ref
