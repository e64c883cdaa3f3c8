"""Kernel F (APIC P2G without the particle CDF) of the PyTorch port, plain
version, against the JAX package's `pallas_transfer.p2g_tiles` in interpret
mode on the same inputs: its collider-free branch on a substep of the
spinning collider-free sand box, its CPIC branch on the main-path dump with
the lattice on the paddle and on the floor.  And the inert body slot of a
world with no bodies, field by field."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from wgsparkl_tpu.ops import pallas_transfer as ptf
from wgsparkl_tpu.pipeline import build_rigid_world as j_build_rigid_world
from wgsparkl_tpu.pipeline import rigid_bodies_update as j_rigid_bodies_update
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch.ops import rows as R
from wgsparkl_tpu_torch.ops.p2g import p2g_plain
from wgsparkl_tpu_torch.pipeline import (
    build_rigid_world, rigid_bodies_update, step_pallas,
)


def _jax_p2g(pdata, itiles, btable, start, length, bcells, cfg, jbody):
    mm, imp = ptf.p2g_tiles(
        jnp.asarray(pdata), jnp.asarray(itiles), jnp.asarray(btable),
        {"start": jnp.asarray(start), "len": jnp.asarray(length)},
        jnp.asarray(bcells), cfg.grid, cfg.group, cfg.num_colliders,
        None if jbody is None else jnp.asarray(jbody), by=cfg.by)
    return np.asarray(mm), np.asarray(imp)


def _assert_p2g_close(mm, imp, ref_mm, ref_imp):
    # Both add w (m v - A x_p) and (sum w A) x_node apart, but the JAX
    # kernel contracts a dense window x group matrix product where the port
    # sums each node in the lists order: f32 roundoff relative to the
    # largest entry (the kernel-A precedent).
    np.testing.assert_allclose(mm, ref_mm, rtol=0, atol=2e-6 * np.abs(ref_mm).max())
    np.testing.assert_allclose(imp, ref_imp, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ref_imp).max()))


def test_p2g_collider_free_matches_jax():
    """nc = 0 on the third substep of the spinning collider-free sand box
    (nonzero affine rows): the inputs come from the port's recorded
    substep, whose sort and job table match the JAX package's."""
    data = H.jax_scene_free(3)
    cfg = interop.config_from_reference(data.config)
    assert cfg.num_colliders == 0 and data.num_particles == 1024
    params = interop.params_from_reference(data.params, "cpu")
    state = step_pallas(interop.state_from_reference(data.state, "cpu"), params,
                        cfg, 2)
    rec = {}
    step_pallas(state, params, cfg, 1, record=rec)
    assert float(rec["pdata"][7:16].abs().max()) > 0.0
    jobs, bcells, jbody = rec["jobs"], rec["bcells"], rec["jbody"]
    assert not bool(jbody.any())
    mm, imp = p2g_plain(rec["pdata"], rec["ntiles"], rec["btable"], jobs, bcells,
                        jbody, cfg.grid.cell_width, cfg.by, 0)
    ref_mm, ref_imp = _jax_p2g(rec["pdata"].numpy(), rec["ntiles"].numpy(),
                               rec["btable"].numpy(), jobs["start"].numpy(),
                               jobs["len"].numpy(), bcells.numpy(), data.config,
                               None)
    _assert_p2g_close(mm.numpy(), imp.numpy(), ref_mm, ref_imp)
    assert not imp.any() and not ref_imp.any()
    # Every particle's mass lands on the grid.
    np.testing.assert_allclose(float(mm[..., 3].sum()),
                               float(rec["pdata"][6, :data.num_particles].sum()),
                               rtol=1e-5)


def _window_tiles(d, cfg, jobs, bcells, jbody):
    """The dump's node tiles [MAXJ, wpad, 4] with the moving paddle merged
    in at gate-level-2 jobs: the window CDF kernel A sees.  (The gathered
    tiles hold the static colliders only, none of which the lattice
    crosses, so with them no pair is incompatible.)"""
    h = cfg.grid.cell_width
    wsh, wvol, _ = R.window_geom(cfg.by)
    naff, closest, dist = R.window_cdf(
        H.to_torch(d["ntiles"]), R.window_positions(bcells, h, wsh),
        H.to_torch(d["btable"]), H.moving_of(cfg), jbody, h, wvol)
    tiles = torch.zeros(d["ntiles"].shape)
    tiles[:, :wvol] = torch.stack([*R.aff_halves(naff), closest, dist], -1)
    return tiles


@pytest.mark.parametrize("scene", ["on_paddle", "on_floor"])
def test_p2g_cpic_branch_matches_jax(scene):
    """nc > 0 on the main-path dump (the particles' fresh CDF rows, the
    window CDF, the gate levels): W masked by CPIC compatibility from the
    stored affinity words, impulses of the incompatible pairs."""
    data, d = H.jax_dump(H.SHIFTS[scene])
    cfg = data.config
    jobs, bcells, jbody = H.port_jobs(d)
    tiles = _window_tiles(d, cfg, jobs, bcells, jbody)
    mm, imp = p2g_plain(H.to_torch(d["pdata"]), tiles, H.to_torch(d["btable"]),
                        jobs, bcells, jbody, cfg.grid.cell_width, cfg.by,
                        cfg.num_colliders)
    ref_mm, ref_imp = _jax_p2g(d["pdata"], tiles.numpy(), d["btable"],
                               d["start"], d["len"], d["bcells"], cfg, d["jbody"])
    _assert_p2g_close(mm.numpy(), imp.numpy(), ref_mm, ref_imp)
    if scene == "on_paddle":
        assert np.abs(ref_imp).max() > 1.0


@pytest.mark.parametrize("dim", [3, 2])
def test_empty_world_is_one_inert_slot_like_jax(dim):
    """No bodies: one slot in both packages, equal field by field, which the
    body update leaves as it is (zero impulses, inverse mass 0)."""
    ref = j_build_rigid_world([], dim)
    world = build_rigid_world([], dim, "cpu")
    assert world.count == 1
    for f in dataclasses.fields(world):
        np.testing.assert_array_equal(getattr(world, f.name).numpy(),
                                      np.asarray(getattr(ref, f.name)))
    data = H.jax_scene_free(dim)
    params = interop.params_from_reference(data.params, "cpu")
    cfg = interop.config_from_reference(data.config)
    z = torch.zeros((1, dim))
    za = torch.zeros((1, 3 if dim == 3 else 1))
    out = rigid_bodies_update(world, z, za, params, cfg)
    jout = j_rigid_bodies_update(ref, jnp.zeros((1, dim)),
                                 jnp.zeros((1, za.shape[1])), data.params,
                                 data.config)
    for f in dataclasses.fields(world):
        np.testing.assert_array_equal(getattr(out, f.name).numpy(),
                                      getattr(world, f.name).numpy())
        np.testing.assert_array_equal(getattr(out, f.name).numpy(),
                                      np.asarray(getattr(jout, f.name)))
    assert not world.inv_mass.any()
