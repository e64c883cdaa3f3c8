"""The 2D chan-free CDF mode of the PyTorch port against the JAX package:
the window node CDF (`_moving_node_cdf_2d`) for every analytic shape, the
chan-free branches of kernels G (particle CDF), H (P2G) and I (G2P), plain
versions, against the JAX kernels in interpret mode on the phase dump of
the stirred column, `step_pallas` over two scenes forced chan-free, and the
construction-time CDF-mode heuristic in 2D.  The heuristic picks chan-free
for scenes whose colliders stay clear of the matter, where a few substeps
may gate no job at all, so every kernel and slice test here runs a scene in
contact and asserts that some jobs are gated."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from wgsparkl_tpu.collision import shapes as jshp
from wgsparkl_tpu.ops.pallas_transfer2d import _moving_node_cdf_2d
from wgsparkl_tpu.pipeline import step_pallas as j_step
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch.collision import cdf_channel as cch
from wgsparkl_tpu_torch.ops import rows as R
from wgsparkl_tpu_torch.ops.transfer2d import g2p_rows, p2g_tiles, pcdf_rows
from wgsparkl_tpu_torch.pipeline import step_pallas, step_with_diag

SUBSTEPS = 5
_j_step = jax.jit(j_step, static_argnums=(2, 3))

# Two posed colliders of each shape (rotation angle, translation, shape
# parameters), overlapping so that nodes lie in reach of both.
_POSES = {
    jshp.SHAPE_CUBOID: [(0.3, (0.2, 0.1), (1.0, 0.6)), (-0.8, (1.1, 0.4), (0.5, 0.9))],
    jshp.SHAPE_BALL: [(0.0, (0.0, 0.0), (0.8,)), (1.1, (0.9, 0.5), (0.6,))],
    jshp.SHAPE_CAPSULE: [(1.2, (0.0, 0.2), (1.0, 0.3)), (-0.4, (0.6, -0.5), (0.4, 0.5))],
    jshp.SHAPE_HALFSPACE: [(0.2, (0.0, -0.3), ()), (2.5, (0.5, 1.2), ())],
}


def _body_table(colliders):
    """2D body table [16, 128] (rows 5-6 rotation, 7-8 translation, 9-11
    shape parameters) of ((shape, (angle, translation, params)), ...)."""
    bt = np.zeros((16, 128), np.float32)
    for slot, (_, (angle, trans, par)) in enumerate(colliders):
        bt[5:7, slot] = np.cos(angle), np.sin(angle)
        bt[7:9, slot] = trans
        bt[9:9 + len(par), slot] = par
    return bt


@pytest.mark.parametrize("shape", ["cuboid", "ball", "capsule", "halfspace", "all"])
def test_window_node_cdf_2d_matches_jax(shape):
    """rows.moving_node_cdf at 2D nodes (the plain version of the kernels'
    window_node_cdf2) against `_moving_node_cdf_2d` on one body table:
    affinity and closest bit for bit, distances to 1e-6 (XLA:CPU may
    contract the rotations' multiply-adds).  The nodes include a ball's
    centre and points on a capsule's axis, where the projections take
    their `n > 1e-12` selects."""
    if shape == "all":
        colliders = [(st, poses[0]) for st, poses in _POSES.items()]
    else:
        st = getattr(jshp, f"SHAPE_{shape.upper()}")
        colliders = [(st, pose) for pose in _POSES[st]]
    desc = tuple((slot, st) for slot, (st, _) in enumerate(colliders))
    bt = _body_table(colliders)
    h = 0.25
    g = np.arange(-12, 13, dtype=np.float32) * h
    xw = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    xw = np.concatenate([xw, bt[7:9, :len(desc)].T], 0)   # the centres
    rd, ra, rc = (np.asarray(a)[:, 0] for a in _moving_node_cdf_2d(
        jnp.asarray(xw), jnp.asarray(bt), desc, h))
    dist, aff, closest = R.moving_node_cdf(torch.as_tensor(xw), torch.as_tensor(bt),
                                           desc, h)
    np.testing.assert_array_equal(aff.numpy().view(np.uint32), ra)
    np.testing.assert_array_equal(closest.numpy(), rc)
    np.testing.assert_allclose(dist.numpy(), rd, rtol=0, atol=1e-6)
    hit = rc >= 0
    assert hit.sum() > 20 and (~hit).sum() > 20
    assert np.all(dist.numpy()[~hit] == np.float32(cch.BIG))
    inside = (ra >> 16) != 0
    assert inside.any() and (hit & ~inside).any()
    if shape == "all":
        assert set(rc[hit].astype(int).tolist()) == {0, 1, 2, 3}


@functools.lru_cache(maxsize=None)
def _stirred():
    """The phase dump of the stirred column in the chan-free mode: its jobs
    and tiles as the port takes them."""
    data, d = H.dump_phases_2d(H.jax_scene_2d_moving(chan_free=True))
    cfg = data.config
    assert cfg.chan_free and cfg.num_colliders == 3 and d["ntiles"].shape[0] == 1
    live = d["len"] > 0
    assert (d["jbody"][live] > 0).sum() > 3 and (d["jbody"][live] == 0).any()
    alldesc = tuple(enumerate(cfg.collider_types))
    return data, d, H.port_jobs(d) + (cfg.grid.cell_width,), alldesc


def test_pcdf2d_chan_free_matches_jax():
    data, d, jobs, alldesc = _stirred()
    cfg = data.config
    out = pcdf_rows(H.to_torch(d["rows"]), H.to_torch(d["ntiles"]), *jobs,
                    cfg.group, d["rows"].shape[1], cfg.num_colliders,
                    H.to_torch(d["btable"]), alldesc, chan_free=True).numpy()
    ce = int(d["covered_end"])
    # Affinity words (split halves): bit for bit.
    np.testing.assert_array_equal(out[[0, 4], :ce], d["pcdf"][[0, 4], :ce])
    assert (d["pcdf"][0, :ce] != 0).sum() > 20
    # Signed distance and normal: the tolerance of the gathered kernel G
    # against JAX (test_torch_2d_kernels.test_pcdf2d_matches_jax): a 3x3
    # MLS solve of 9-node sums, which the JAX kernel takes over the window.
    np.testing.assert_allclose(out[1:4, :ce], d["pcdf"][1:4, :ce], rtol=0,
                               atol=5e-4)


def test_p2g2d_chan_free_matches_jax():
    data, d, jobs, alldesc = _stirred()
    mm, imp = p2g_tiles(H.to_torch(d["pdata"]), H.to_torch(d["ntiles"]),
                        H.to_torch(d["btable"]), *jobs, data.config.num_colliders,
                        alldesc, chan_free=True)
    # The gathered kernel H's tolerances: sums over a job's particles in
    # another order (the JAX kernel contracts window x group matrices).
    np.testing.assert_allclose(mm.numpy(), d["mm"], rtol=0,
                               atol=2e-6 * np.abs(d["mm"]).max())
    np.testing.assert_allclose(imp.numpy(), d["imp"], rtol=0,
                               atol=1e-5 * max(1.0, np.abs(d["imp"]).max()))
    # The kinematic ball and capsule stir inside the column: impulses.
    assert np.abs(d["imp"][:, :, 1:3]).max() > 1e-3


def test_g2p2d_chan_free_matches_jax():
    data, d, jobs, alldesc = _stirred()
    cfg = data.config
    krows = g2p_rows(H.to_torch(d["pdata"]), H.to_torch(d["ftiles"]),
                     H.to_torch(d["ntiles"]), H.to_torch(d["btable"]), *jobs,
                     cfg.group, d["rows"].shape[1], cfg.num_colliders, alldesc,
                     chan_free=True)
    ce = int(d["covered_end"])
    # The gathered kernel I's tolerance: f32 roundoff of 9-node sums.
    np.testing.assert_allclose(krows.numpy()[:6, :ce], d["krows"][:6, :ce],
                               rtol=0, atol=1e-5)


def _slice(data, fold_vel):
    params = interop.params_from_reference(data.params, "cpu")
    cfg = interop.config_from_reference(data.config)
    assert cfg.chan_free and cfg.fold_vel == fold_vel
    assert cfg == H.port_data(data, chan_free=True, fold_vel=fold_vel).config
    ref = _j_step(data.state, data.params, data.config, SUBSTEPS)
    state = interop.state_from_reference(data.state, "cpu")
    out, diag = step_with_diag(state, params, cfg, SUBSTEPS - 1)
    assert not diag.any_overflow()
    rec = {}
    out = step_pallas(out, params, cfg, 1, record=rec)
    live = rec["jobs"]["len"] > 0
    assert int((rec["jbody"][live] > 0).sum()) > 3
    assert rec["ntiles"].shape[0] == 1
    H.compare_states(ref, out)


def test_step_pallas_2d_stirred_chan_free_matches_jax():
    """The stirred column forced chan-free, 5 substeps."""
    _slice(H.jax_scene_2d_moving(chan_free=True), False)


def test_step_pallas_2d_in_floor_chan_free_folded_matches_jax():
    """The sand column lowered 1.5 cells into its floor, forced chan-free
    with the grid update folded into kernel I, 5 substeps."""
    data = H.jax_scene_2d("sand_column", H.SHIFTS_2D["in_floor"], chan_free=True,
                          fold_vel=True)
    _slice(data, True)


@pytest.mark.parametrize("where", sorted(H.BALL_2D))
def test_cdf_mode_heuristic_2d_matches_jax(where):
    """The sand column with one kinematic ball and no floor: the port's
    heuristic resolves the mode the JAX package's does (chan-free with the
    ball aside, not with it under the column's foot), and the port builds
    and steps the scene as the JAX package does."""
    data = H.jax_scene_2d_ball(where)
    port = H.port_data(data, chan_free=None)
    assert port.config.chan_free == data.config.chan_free == (where == "aside")
    assert port.config == interop.config_from_reference(data.config)
    if where == "aside":
        ref = _j_step(data.state, data.params, data.config, 3)
        out = step_pallas(port.state, port.params, port.config, 3)
        H.compare_states(ref, out, colliders=False)
