"""The port's sparse domain past its capacities against the JAX package's:
tests/test_sparse_domain.py's sand box, lowered 4.5 cells into the reach of
its floor and paddle, at kmax = 8 and amax = 16 (12 occupied blocks, 44
active), five substeps each from the JAX state.  Both packages must report
the same overflow counters in every substep.  Blocks past kmax freeze
their particles in the port (ops/blocked.py freeze_truncated_blocks); the
JAX package's job table lets them ride the last kept block's jobs instead
(ROADMAP queue 3), so the states are held to the JAX package with that
table cut back the same way (patched for the test, no file changed), at
tests/torch_port_helpers.compare_states' tolerances (positions 1e-5,
velocities 1e-4, F 1e-4, affinity words exact, bodies 1e-6); the
unpatched package's motion of the frozen particles is counted."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np

from test_torch_sparse_domain import _sparse_box
from torch_port_helpers import compare_states, port_data
from wgsparkl_tpu.ops import blocked as jbk
from wgsparkl_tpu.pipeline import step_with_diag as j_step_with_diag
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch.pipeline import step_with_diag


@contextlib.contextmanager
def _jax_freezes_truncated_blocks():
    """The JAX package's build_jobs_sparse, for the block, with the last
    kept block's jobs cut at the end of its own lanes, so that blocks past
    kmax freeze their particles, as its comment says they do and as the
    port's table does (ops/blocked.py freeze_truncated_blocks).  Unpatched,
    their particles ride the last kept block's jobs (ROADMAP queue 3).  No
    file of the package changes; a jit traced inside the block sees the
    patch."""
    real = jbk.build_jobs_sparse

    def frozen(sorted_keys, group, max_jobs, kmax):
        jobs, okeys, n_occ = real(sorted_keys, group, max_jobs, kmax)
        last = jnp.max(jnp.where(okeys < jbk.SPARSE_SENTINEL, okeys, -1))
        end = jnp.searchsorted(sorted_keys, last, side="right").astype(jnp.int32)
        length = jnp.maximum(jnp.minimum(jobs["len"], end - jobs["start"]), 0)
        return dict(jobs, len=length), okeys, n_occ

    jbk.build_jobs_sparse = frozen
    try:
        yield
    finally:
        jbk.build_jobs_sparse = real


def test_sparse_overflow_counters_match_jax():
    """Five substeps, each from the JAX package's state (the lowered sand
    lattice rests at the Drucker-Prager cone tip, where roundoff flips the
    return map's branch and grows from substep to substep): the counters of
    every substep equal; the states within compare_states' tolerances of
    the JAX package with blocks past kmax frozen, the port's truncated
    blocks' particles unmoved; and the unpatched JAX package moving them."""
    jd = _sparse_box(4.5, kmax=8, amax=16)
    cfg = interop.config_from_reference(jd.config)
    assert cfg == port_data(jd).config
    params = interop.params_from_reference(jd.params, "cpu")
    with _jax_freezes_truncated_blocks():
        j_step = jax.jit(lambda s, p, c, n: j_step_with_diag(s, p, c, n),
                         static_argnums=(2, 3))
        ref, _ = j_step(jd.state, jd.params, jd.config, 1)
    state = jd.state
    for i in range(5):
        ref, jdiag = j_step(state, jd.params, jd.config, 1)
        out, diag = step_with_diag(interop.state_from_reference(state, "cpu"), params,
                                   cfg, 1)
        for f in ("job_overflow", "sparse_occ_overflow", "sparse_act_overflow"):
            assert int(getattr(diag, f)) == int(getattr(jdiag, f)), f
        compare_states(ref, out)
        if i == 0:
            # The truncated blocks' particles: the port leaves them as they
            # were; the unpatched JAX package moves them.
            pos0 = np.asarray(state.particles.pos)[np.argsort(np.asarray(
                state.particles.ids))]
            still = (out.particles.pos.numpy()[np.argsort(out.particles.ids.numpy())]
                     == pos0).all(1)
            raw, _ = jax.jit(j_step_with_diag, static_argnums=(2, 3))(
                state, jd.params, jd.config, 1)
            moved = (np.asarray(raw.particles.pos)[np.argsort(np.asarray(
                raw.particles.ids))] != pos0).any(1)
            print(f"overflow box: {int(still.sum())} of {len(still)} particles frozen "
                  f"by the port, {int((still & moved).sum())} of them moved by the "
                  "unpatched JAX package")
            assert still.sum() > 100 and (still & moved).any()
        state = ref
    assert int(diag.sparse_occ_overflow) > 0 and int(diag.sparse_act_overflow) > 0
    assert diag.any_overflow() and "sparse_occ_overflow" in diag.summary()
    print(f"overflow box: {diag.summary()}")
