"""The PyTorch port's main path with the sand lattice lowered onto the
spinning paddle (gate level 2 everywhere, nonzero CPIC impulses), substep
by substep against the JAX package: each of 10 substeps starts both
packages from the JAX state, because the penetrating start amplifies f32
roundoff from substep to substep (measured: 4.6e-5 in velocity per
substep, 8e-4 after 10 free-running substeps)."""

import jax
import numpy as np

import torch_port_helpers as H
from wgsparkl_tpu.pipeline import step_pallas as j_step
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch.pipeline import step_pallas


_j_step = jax.jit(j_step, static_argnums=(2, 3))


def test_step_pallas_contact_matches_jax_per_substep():
    data = H.jax_scene(H.SHIFTS["on_paddle"])
    params = interop.params_from_reference(data.params, "cpu")
    cfg = interop.config_from_reference(data.config)
    state = data.state
    for _ in range(10):
        ref = _j_step(state, data.params, data.config, 1)
        out = step_pallas(interop.state_from_reference(state, "cpu"), params, cfg, 1)
        H.compare_states(ref, out)
        state = ref
