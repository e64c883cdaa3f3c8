"""The PyTorch port's blocked transfer (`MpmData(transfer="blocked")`)
against the JAX package's `substep_blocked` and against the port's dense
transfer: tests/test_blocked.py's 3D scene with and without bodies, its job
table overflow (max_jobs 8) lane for lane, and a 2D sand column.

Particles come back block-sorted: `ids` must equal JAX's, lane for lane.
Tolerances are tests/test_blocked.py's (pos 5e-6, vel 5e-5, F 5e-5,
affinity words exact, bodies 1e-6): the port runs the dense kernels on the
sorted rows, JAX its one-hot matrix products, so floats agree to fp32
roundoff."""

import dataclasses

import jax
import numpy as np
import pytest
from test_blocked import _scene_3d

from wgsparkl_tpu import scenes as jscenes
from wgsparkl_tpu.pipeline import substep_blocked
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch.pipeline import step, step_with_diag

_substep = jax.jit(substep_blocked, static_argnums=2)


def _port(state, params, cfg, substeps):
    return step(interop.state_from_reference(state, "cpu"),
                interop.params_from_reference(params, "cpu"),
                interop.config_from_reference(cfg), substeps)


def _jax(state, params, cfg, substeps):
    for _ in range(substeps):
        state = _substep(state, params, cfg)
    return state


def _assert_blocked(ref, out, bodies=True, ids_ref=None):
    """test_blocked.py's tolerances; ref's particles in the order of ids
    (JAX's, or the dense path's identity order when ids_ref is given)."""
    op = out.particles
    ids = op.ids.numpy()
    if ids_ref is None:
        np.testing.assert_array_equal(ids, np.asarray(ref.particles.ids))
        sel = slice(None)
    else:
        sel = ids_ref(ids)
    rp = ref.particles
    np.testing.assert_allclose(op.pos.numpy(), np.asarray(rp.pos)[sel], rtol=0, atol=5e-6)
    np.testing.assert_allclose(op.vel.numpy(), np.asarray(rp.vel)[sel], rtol=0, atol=5e-5)
    np.testing.assert_allclose(op.def_grad.numpy(), np.asarray(rp.def_grad)[sel], rtol=0,
                               atol=5e-5)
    np.testing.assert_array_equal(op.cdf_affinity.numpy().view(np.uint32),
                                  np.asarray(rp.cdf_affinity).view(np.uint32)[sel])
    if bodies:
        for f in ("pos", "linvel"):
            np.testing.assert_allclose(getattr(out.bodies, f).numpy(),
                                       np.asarray(getattr(ref.bodies, f)), rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("with_bodies", [False, True])
def test_blocked_matches_jax(with_bodies):
    """30 substeps of the port's blocked path against JAX's substep_blocked
    (group 64, job_chunk 8): ids equal lane for lane, test_blocked.py's
    tolerances; with bodies the CPIC gave affinity."""
    _, db = _scene_3d(with_bodies)
    ref = _jax(db.state, db.params, db.config, 30)
    out = _port(db.state, db.params, db.config, 30)
    assert not np.array_equal(np.asarray(ref.particles.ids), np.arange(512))
    _assert_blocked(ref, out)
    if with_bodies:
        assert (np.asarray(ref.particles.cdf_affinity) != 0).any()


@pytest.mark.parametrize("with_bodies", [False, True])
def test_blocked_matches_dense(with_bodies):
    """The port's blocked path against its dense path (as
    test_blocked_matches_dense_3d holds JAX's), 30 substeps, particles by
    identity; the blocked step reports a zero StepDiag."""
    dd, db = _scene_3d(with_bodies)
    cd = interop.config_from_reference(dd.config)
    assert cd.transfer == "dense"
    dense = _port(dd.state, dd.params, dd.config, 30)
    out, diag = step_with_diag(interop.state_from_reference(db.state, "cpu"),
                               interop.params_from_reference(db.params, "cpu"),
                               interop.config_from_reference(db.config), 30)
    assert not diag.any_overflow()
    _assert_blocked(dense, out, with_bodies, ids_ref=lambda ids: ids)


def test_blocked_overflow_matches_jax():
    """test_blocked_job_overflow_is_safe's table, max_jobs 8 with group 64
    (512 particles need more): the jobs past it are dropped; 3 substeps
    against JAX lane for lane, the dropped lanes (zero velocity from G2P)
    included."""
    _, db = _scene_3d(False)
    cfg = dataclasses.replace(db.config, max_jobs=8, job_chunk=8, group=64)
    ref = _jax(db.state, db.params, cfg, 3)
    out = _port(db.state, db.params, cfg, 3)
    _assert_blocked(ref, out, bodies=False)
    still = np.abs(np.asarray(ref.particles.vel)).sum(1) == 0.0
    assert still.sum() > 0 and (~still).sum() > 0
    np.testing.assert_array_equal(np.abs(out.particles.vel.numpy()).sum(1) == 0.0, still)


def test_blocked_2d_matches_jax():
    """A 2D sand column (sand_column_2d, 16 x 32 particles, cell width 0.5,
    8 x 8 blocks, group 64): 10 substeps against JAX's substep_blocked."""
    d2 = jscenes.sand_column_2d(nx=16, ny=32, cell_width=0.5, transfer="blocked",
                                group=64, job_chunk=8)
    ref = _jax(d2.state, d2.params, d2.config, 10)
    out = _port(d2.state, d2.params, d2.config, 10)
    _assert_blocked(ref, out)
    assert (np.asarray(ref.particles.cdf_affinity) != 0).any()
