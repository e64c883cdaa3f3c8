"""The port's one-substep entry points `substep_pallas` (3D and 2D),
`substep` and `substep_blocked` (wgsparkl_tpu_torch/pipeline.py) against
the JAX package's functions of the same names, and against the port's own
frames.

Each scene takes 5 calls.  Against JAX: `compare_states`' tolerances for
the kernel path (position 1e-5, velocity and F 1e-4, bodies 1e-6, ids and
affinity words equal); tests/test_blocked.py's for the dense and blocked
transfers (tests/test_torch_blocked_transfer.py's `_assert_blocked`).  The
lattice lowered onto the paddle starts inside it, which amplifies f32
roundoff from substep to substep (tests/test_torch_slice_contact.py), so
each of its calls starts both packages from the JAX state.  Against the
port's own frame of 5 substeps (step_pallas, step_dense): every leaf bit for
bit.  A call packs and unpacks the row matrix, which round-trips exactly,
and substep_pallas evaluates every collider's node CDF each call where the
frame hoists the static ones: the hoist merged with the moving colliders
gives the same triple (pipeline._node_cdf_full), and the kernels' in-kernel
merge of the moving ones is exact."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_blocked import _scene_3d
from test_torch_blocked_transfer import _assert_blocked

import torch_port_helpers as H
from wgsparkl_tpu import scenes as jscenes
from wgsparkl_tpu.pipeline import substep as j_substep
from wgsparkl_tpu.pipeline import substep_blocked as j_substep_blocked
from wgsparkl_tpu.pipeline import substep_pallas as j_substep_pallas
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch.pipeline import (step_dense, step_pallas, substep,
                                         substep_blocked, substep_pallas)
from wgsparkl_tpu_torch.utils import checkpoint

torch.set_num_threads(2)
CALLS = 5
_JAX = {"pallas": jax.jit(j_substep_pallas, static_argnums=2),
        "dense": jax.jit(j_substep, static_argnums=2),
        "blocked": jax.jit(j_substep_blocked, static_argnums=2)}
_PORT = {"pallas": substep_pallas, "dense": substep, "blocked": substep_blocked}


def _scene(name):
    """(JAX MpmData, per-call start from JAX's state)."""
    if name == "3d":
        return H.jax_scene(), False
    if name == "3d_on_paddle":
        return H.jax_scene(H.SHIFTS["on_paddle"]), True
    if name == "2d_column":
        return H.jax_scene_2d("sand_column", H.SHIFTS_2D["in_floor"]), False
    if name == "2d_blocks":
        return H.jax_scene_2d("elastic_blocks"), False
    if name == "3d_bodies":
        return _scene_3d(True)[1], False
    if name == "2d_sand":
        return jscenes.sand_column_2d(nx=16, ny=32, cell_width=0.5, transfer="blocked",
                                      group=64, job_chunk=8), False
    raise KeyError(name)


def _run(kind, name):
    """(JAX state, port state) after CALLS calls of the entry point."""
    jd, per_call = _scene(name)
    params = interop.params_from_reference(jd.params, "cpu")
    cfg = interop.config_from_reference(jd.config)
    ref, out = jd.state, interop.state_from_reference(jd.state, "cpu")
    for _ in range(CALLS):
        if per_call:
            out = interop.state_from_reference(ref, "cpu")
        ref = _JAX[kind](ref, jd.params, jd.config)
        out = _PORT[kind](out, params, cfg)
        if per_call:
            H.compare_states(ref, out)
    return ref, out


def _same_leaves(a, b):
    la, lb = checkpoint.named_leaves(a), checkpoint.named_leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), name


@pytest.mark.parametrize("name", ["3d", "3d_on_paddle", "2d_column", "2d_blocks"])
def test_substep_pallas_matches_jax(name):
    ref, out = _run("pallas", name)
    H.compare_states(ref, out)


@pytest.mark.parametrize("name", ["3d", "3d_on_paddle", "2d_column", "2d_blocks"])
def test_substep_pallas_equals_frame(name):
    jd, _ = _scene(name)
    params = interop.params_from_reference(jd.params, "cpu")
    cfg = interop.config_from_reference(jd.config)
    state = interop.state_from_reference(jd.state, "cpu")
    assert cfg.static_slots and not cfg.chan_free
    out = state
    for _ in range(CALLS):
        out = substep_pallas(out, params, cfg)
    _same_leaves(out, step_pallas(state, params, cfg, CALLS))


@pytest.mark.parametrize("name", ["3d_bodies", "2d_sand", "3d"])
def test_substep_matches_jax(name):
    """The dense substep whatever cfg.transfer says: the blocked scenes'
    configurations and the kernel path's sand box with its paddle."""
    ref, out = _run("dense", name)
    _assert_blocked(ref, out, bodies=name != "3d")
    if name == "3d":
        H.compare_states(ref, out)


@pytest.mark.parametrize("name", ["3d_bodies", "2d_sand"])
def test_substep_blocked_matches_jax(name):
    """Particles come out block-sorted: ids equal JAX's lane for lane."""
    ref, out = _run("blocked", name)
    assert not np.array_equal(out.particles.ids.numpy(),
                              np.arange(out.particles.count))
    _assert_blocked(ref, out)
    assert (np.asarray(ref.particles.cdf_affinity) != 0).any()


@pytest.mark.parametrize("kind", ["dense", "blocked"])
def test_substep_and_blocked_equal_frame(kind):
    jd, _ = _scene("3d_bodies")
    params = interop.params_from_reference(jd.params, "cpu")
    cfg = dataclasses.replace(interop.config_from_reference(jd.config), transfer=kind)
    state = interop.state_from_reference(jd.state, "cpu")
    out = state
    for _ in range(CALLS):
        out = _PORT[kind](out, params, cfg)
    _same_leaves(out, step_dense(state, params, cfg, CALLS))


def test_substep_refuses_the_sparse_domain():
    jd = H.jax_scene()
    cfg = dataclasses.replace(interop.config_from_reference(jd.config), sparse=True,
                              by=4, kmax=64, amax=256)
    state = interop.state_from_reference(jd.state, "cpu")
    params = interop.params_from_reference(jd.params, "cpu")
    for fn in (substep, substep_blocked):
        with pytest.raises(ValueError, match="sparse"):
            fn(state, params, cfg)
