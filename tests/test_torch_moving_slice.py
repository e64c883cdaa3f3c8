"""The PyTorch port's per-substep dense node CDF against the JAX package:
a 3D scene whose colliders all move (a halfspace floor sliding along x, a
spinning capsule paddle under the lowered lattice and a spinning ball), and
the 2D sand column stirred by a kinematic ball and a kinematic capsule over
its static floor (the frame's static node CDF merged with the moving
colliders' every substep).  The 3D scene starts in contact, so each of its
substeps starts both packages from the JAX state; the 2D one runs free."""

import jax

import torch_port_helpers as H
from wgsparkl_tpu.pipeline import step_pallas as j_step
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch.pipeline import step_pallas


_j_step = jax.jit(j_step, static_argnums=(2, 3))


def _port(data):
    params = interop.params_from_reference(data.params, "cpu")
    cfg = interop.config_from_reference(data.config)
    assert cfg == H.port_data(data, chan_free=False).config
    return params, cfg


def test_step_pallas_all_kinematic_matches_jax():
    data = H.jax_scene_kinematic()
    params, cfg = _port(data)
    assert cfg.static_slots == () and not cfg.chan_free
    state = data.state
    for _ in range(3):
        ref = _j_step(state, data.params, data.config, 1)
        out = step_pallas(interop.state_from_reference(state, "cpu"), params, cfg, 1)
        H.compare_states(ref, out)
        state = ref


def test_step_pallas_2d_moving_colliders_match_jax():
    data = H.jax_scene_2d_moving()
    params, cfg = _port(data)
    assert cfg.static_slots == (0,) and cfg.num_colliders == 3
    ref = _j_step(data.state, data.params, data.config, 5)
    out = step_pallas(interop.state_from_reference(data.state, "cpu"), params, cfg, 5)
    H.compare_states(ref, out)
