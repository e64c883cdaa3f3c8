"""`fold_vel` in the PyTorch port against the JAX package: the grid update
(momentum to velocity, gravity, the one-cell clamp) done inside G2P on the
window nodes instead of on the whole grid.  The fold branches of kernels B
(3D) and I (2D), plain versions, against the JAX kernels' `fold_vel=True`
in interpret mode: B on the coupled sand box lowered onto the paddle and
on the spinning collider-free lattice, I on the 2D sand column; then
`step_pallas` of the folded 3D sand box and 2D sand column.

The fold computes clip((mom + m g dt) * nr_recip(max(m, 1e-30))), which
rounds otherwise than the unfolded (mom + m g dt) * (1 / max(m, 1e-30)),
so folded runs are held against JAX's folded runs only.  XLA:CPU may
contract mom + m g dt into one fused multiply-add, so node velocities
agree with JAX to a few ulp; the G2P rows keep their kernels' tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_port_helpers as H
from wgsparkl_tpu.ops import pallas_transfer as ptf
from wgsparkl_tpu.pipeline import step_pallas as j_step
from wgsparkl_tpu_torch import interop, scenes
from wgsparkl_tpu_torch.ops import rows as R
from wgsparkl_tpu_torch.ops.g2p import g2p_rows
from wgsparkl_tpu_torch.ops.transfer2d import g2p_rows as g2p_rows2d
from wgsparkl_tpu_torch.pipeline import step_pallas, step_with_diag

_j_step = jax.jit(j_step, static_argnums=(2, 3))


def test_fold_vel_configuration():
    """MpmData(fold_vel=None) resolves to off, as in the JAX package; True
    is carried in 3D and 2D, and over from a JAX configuration."""
    d3 = scenes.sand_box_3d(nxz=4, ny=6, by=8, device="cpu")
    assert not d3.config.fold_vel
    d3 = scenes.sand_box_3d(nxz=4, ny=6, by=8, device="cpu", fold_vel=True)
    d2 = scenes.sand_column_2d(nx=4, ny=4, cell_width=0.5, device="cpu",
                               fold_vel=True)
    assert d3.config.fold_vel and d2.config.fold_vel
    jdata = H.jax_scene(fold_vel=True)
    assert jdata.config.fold_vel
    assert interop.config_from_reference(jdata.config).fold_vel


def _assert_fold_matters(unfolded, krows, ce):
    """The raw momentum tiles read as velocities give other rows: the fold
    branch is what the comparison exercised."""
    assert np.abs(unfolded[:6, :ce] - krows[:6, :ce]).max() > 1e-2


def test_g2p_fold_matches_jax():
    """Kernel B folded, on the sand box lowered onto the paddle (every job
    at gate level 2, incompatible pairs)."""
    data, d = H.jax_dump(H.SHIFTS["on_paddle"], fold_vel=True)
    cfg = data.config
    assert cfg.fold_vel
    jobs, bcells, jbody = H.port_jobs(d)
    args = (H.to_torch(d["pdata"]), H.to_torch(d["ftiles"]),
            H.to_torch(d["ntiles"]), H.to_torch(d["btable"]), jobs, bcells, jbody,
            cfg.grid.cell_width, cfg.by, cfg.group, d["rows"].shape[1],
            cfg.num_colliders, H.moving_of(cfg))
    krows = g2p_rows(*args, fold_vel=True).numpy()
    ce = int(d["covered_end"])
    assert set(np.unique(d["jbody"][d["len"] > 0]).tolist()) == {2}
    # B's tolerance (test_torch_transfer_kernels.test_g2p_matches_jax).
    np.testing.assert_allclose(krows[:12, :ce], d["krows"][:12, :ce], rtol=0,
                               atol=1e-5)
    _assert_fold_matters(g2p_rows(*args).numpy(), d["krows"], ce)


def test_g2p_fold_collider_free_matches_jax():
    """Kernel B folded at nc = 0, on the third substep of the spinning
    collider-free lattice: the inputs come from the port's recorded
    substep, whose sort and job table match the JAX package's."""
    data = H.jax_scene_free(3)
    params = interop.params_from_reference(data.params, "cpu")
    cfg = H.port_data(data, fold_vel=True).config
    assert cfg.num_colliders == 0 and cfg.fold_vel
    state = step_pallas(interop.state_from_reference(data.state, "cpu"), params,
                        cfg, 2)
    rec = {}
    step_pallas(state, params, cfg, 1, record=rec)
    assert rec["fold_vel"] and float(rec["ftiles"][..., 3].max()) > 0.0
    jobs, bcells = rec["jobs"], rec["bcells"]
    npad = rec["rows"].shape[1]
    krows = g2p_rows(rec["pdata"], rec["ftiles"], rec["ntiles"], rec["btable"],
                     jobs, bcells, rec["jbody"], cfg.grid.cell_width, cfg.by,
                     cfg.group, npad, 0, fold_vel=True).numpy()
    ref = np.asarray(ptf.g2p_rows(
        jnp.asarray(rec["pdata"].numpy()), jnp.asarray(rec["ftiles"].numpy()),
        jnp.asarray(rec["ntiles"].numpy()), jnp.asarray(rec["btable"].numpy()),
        {"start": jnp.asarray(jobs["start"].numpy()),
         "len": jnp.asarray(jobs["len"].numpy())},
        jnp.asarray(bcells.numpy()), data.config.grid, cfg.group, npad, 0,
        None, by=cfg.by, fold_vel=True))
    ce = int(rec["covered_end"])
    np.testing.assert_allclose(krows[:12, :ce], ref[:12, :ce], rtol=0, atol=1e-5)
    assert np.abs(ref[:3, :ce]).max() > 1.0       # the spin
    np.testing.assert_array_equal(krows, rec["krows"].numpy())


def test_g2p2d_fold_matches_jax():
    """Kernel I folded, on the 2D sand column (gate levels 0 and 2)."""
    data, d = H.jax_dump_2d("sand_column", 0.0, fold_vel=True)
    cfg = data.config
    assert cfg.fold_vel and not cfg.chan_free
    jobs = H.port_jobs(d) + (cfg.grid.cell_width,)
    args = (H.to_torch(d["pdata"]), H.to_torch(d["ftiles"]),
            H.to_torch(d["ntiles"]), H.to_torch(d["btable"])) + jobs + (
        cfg.group, d["rows"].shape[1], cfg.num_colliders)
    krows = g2p_rows2d(*args, fold_vel=True).numpy()
    ce = int(d["covered_end"])
    assert 2 in set(np.unique(d["jbody"][d["len"] > 0]).tolist())
    # I's tolerance (test_torch_2d_kernels.test_g2p2d_matches_jax).
    np.testing.assert_allclose(krows[:6, :ce], d["krows"][:6, :ce], rtol=0,
                               atol=1e-5)
    _assert_fold_matters(g2p_rows2d(*args).numpy(), d["krows"], ce)


def test_fold_velocity_zero_mass_and_clamp():
    """Nodes with no mass get velocity 0; a node whose velocity exceeds the
    one-cell-a-step limit is clamped to it (3D tiles, body-table row 24)."""
    bt = torch.zeros((32, 128))
    bt[24, :3] = torch.tensor([0.0, -0.01, 0.0])
    bt[24, 3] = 5.0
    ft = torch.tensor([[[0.0, 0.0, 0.0, 0.0], [2.0, 20.0, -1.0, 2.0]]])
    v = R.fold_velocity(ft, bt, 3, 24)
    np.testing.assert_array_equal(v[0, 0].numpy(), [0.0, 0.0, 0.0, 0.0])
    np.testing.assert_array_equal(v[0, 1].numpy(), np.float32([1.0, 5.0, -0.5, 2.0]))


def _slice(data, substeps):
    params = interop.params_from_reference(data.params, "cpu")
    cfg = interop.config_from_reference(data.config)
    assert cfg.fold_vel and cfg == H.port_data(data, fold_vel=True).config
    ref = _j_step(data.state, data.params, data.config, substeps)
    out, diag = step_with_diag(interop.state_from_reference(data.state, "cpu"),
                               params, cfg, substeps)
    assert not diag.any_overflow()
    H.compare_states(ref, out)


def test_step_pallas_fold_vel_matches_jax():
    """The 3D sand box with the paddle, folded, 3 substeps."""
    _slice(H.jax_scene(fold_vel=True), 3)


def test_step_pallas_2d_fold_vel_matches_jax():
    """The 2D sand column, folded, 5 substeps."""
    _slice(H.jax_scene_2d("sand_column", fold_vel=True), 5)
