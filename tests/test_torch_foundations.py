"""Foundations of the PyTorch port against the JAX package: channel SVD,
Drucker-Prager return map, material-table dedupe, analytic node CDF, rigid
integration, row packing, the main-path configuration it resolves, and the
card as every constructor's default device."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgsparkl_tpu import scenes as jscenes
from wgsparkl_tpu.collision import cdf_channel as jcch
from wgsparkl_tpu.math.svd import eig33_sigma_ch as j_eig33, svd3x3_ch as j_svd3
from wgsparkl_tpu.models import drucker_prager as jdp
from wgsparkl_tpu.ops import pallas_transfer as jptf
from wgsparkl_tpu.pipeline import MpmData as JMpmData
from wgsparkl_tpu.rigid import body as jbody
from wgsparkl_tpu.solver import attach_material_table as j_attach
from wgsparkl_tpu_torch import interop, scenes
from wgsparkl_tpu_torch.collision import cdf_channel as cch
from wgsparkl_tpu_torch.math import probe
from wgsparkl_tpu_torch.math.svd import eig33_sigma_ch, svd3x3_ch
from wgsparkl_tpu_torch.models import drucker_prager as dp
from wgsparkl_tpu_torch.ops import rows as R
from wgsparkl_tpu_torch.parallel import spatial_config
from wgsparkl_tpu_torch.params import SimulationParams
from wgsparkl_tpu_torch.pipeline import build_rigid_world
from wgsparkl_tpu_torch.rigid import body as body_mod
from wgsparkl_tpu_torch.solver import Models, Particles, attach_material_table

torch.set_num_threads(2)


def _fs(seed, n=512):
    """Deformation gradients: near identity, stretched, inverted and
    rank-deficient cases."""
    rng = np.random.default_rng(seed)
    f = np.eye(3) + 0.3 * rng.standard_normal((n, 3, 3))
    f[: n // 8, :, 2] = 0.0                      # rank deficient
    f[n // 8: n // 4, 0] *= -1.0                 # inverted
    f[n // 4: n // 2] = np.eye(3) + 1e-4 * rng.standard_normal((n // 4, 3, 3))
    return f.astype(np.float32)


def _ch(f, lib):
    return {(i, j): lib(f[:, i, j]) for i in range(3) for j in range(3)}


@pytest.mark.parametrize("seed", [0, 1])
def test_svd3x3_ch_matches_jax(seed):
    f = _fs(seed)
    uj, sj, vj = j_svd3(_ch(f, jnp.asarray))
    ut, st, vt = svd3x3_ch(_ch(f, torch.as_tensor))
    for a, b in zip(sj, st):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5)
    rec = sum(torch.stack(ut[m])[:, None, :] * st[m] * torch.stack(vt[m])[None]
              for m in range(3))                  # [3, 3, n]: U S V^T
    np.testing.assert_allclose(rec.permute(2, 0, 1).numpy(), f, atol=1e-4)
    sig = eig33_sigma_ch(_ch(f, torch.as_tensor))
    sig_j = j_eig33(_ch(f, jnp.asarray))
    for a, b in zip(sig_j, sig):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5)


def test_drucker_prager_matches_jax_and_disabled_is_noop():
    f = _fs(2)
    f[: len(f) // 2] = np.eye(3) + 0.02 * (f[: len(f) // 2] - np.eye(3))
    n = len(f)
    rng = np.random.default_rng(3)
    params = dp.drucker_prager_arrays([dp.DruckerPrager.new(2.0e9, 0.2)])
    params = {k: np.full(n, v[0], np.float32) for k, v in params.items()}
    params["lam"][: n // 4] = -1.0               # plasticity disabled
    state = {"det": np.ones(n, np.float32),
             "hardening": rng.uniform(1.0, 2.0, n).astype(np.float32),
             "log_vol_gain": rng.uniform(-0.01, 0.01, n).astype(np.float32)}
    sj, fj = jdp.drucker_prager_project_ch(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in state.items()}, _ch(f, jnp.asarray))
    st, ft = dp.drucker_prager_project_ch(
        {k: torch.as_tensor(v) for k, v in params.items()},
        {k: torch.as_tensor(v) for k, v in state.items()}, _ch(f, torch.as_tensor))
    for k in sj:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), rtol=1e-4,
                                   atol=1e-4)
    for k in fj:
        np.testing.assert_allclose(ft[k].numpy(), np.asarray(fj[k]), atol=1e-4)
        np.testing.assert_array_equal(ft[k].numpy()[: n // 4], f[: n // 4, k[0], k[1]])


def test_material_table_and_row_packing_match_jax():
    j = jscenes.sand_box_3d(nxz=4, ny=6, transfer="pallas", by=8)
    t = interop.state_from_reference(j.state, "cpu")
    models, n_mat = attach_material_table(t.particles, t.models)
    jm, jn = j_attach(j.state.particles, j.state.models)
    assert n_mat == jn == j.config.n_materials
    np.testing.assert_array_equal(models.mat_table.numpy(), np.asarray(jm.mat_table))
    np.testing.assert_array_equal(models.mat_id.numpy(), np.asarray(jm.mat_id))
    rows = R.pack_rows_padded(t.particles, models, 2048)
    np.testing.assert_array_equal(
        rows.numpy(), np.asarray(jptf.pack_rows_padded(j.state.particles, jm, 2048)))
    p2, m2 = R.unpack_state_rows(rows[:, : t.particles.count], t.particles, models)
    for f in ("pos", "def_grad", "cdf_affinity", "ids", "init_volume"):
        np.testing.assert_array_equal(getattr(p2, f).numpy(),
                                      getattr(t.particles, f).numpy())


def test_node_cdf_channels_match_jax():
    j = jscenes.sand_box_3d(nxz=4, ny=6, transfer="pallas", by=8)
    b = j.state.bodies
    rng = np.random.default_rng(4)
    pos = rng.uniform([-40, -6, -40], [40, 12, 40], (20000, 3)).astype(np.float32)
    pos[:5000, 1] = rng.uniform(-1.0, 2.0, 5000)     # around the floor top
    pos[5000:8000] = rng.uniform([-3, 0, -31], [3, 5, 31], (3000, 3))  # paddle
    types = j.config.collider_types
    dj, aj, cj = jcch.node_cdf_channels(types, b.shape_params, b.rot, b.pos,
                                        [jnp.asarray(pos[:, a]) for a in range(3)],
                                        1.0)
    t = interop.state_from_reference(j.state, "cpu").bodies
    dt_, at, ct = cch.node_cdf_channels(types, t.shape_params, t.rot, t.pos,
                                        [torch.as_tensor(pos[:, a]) for a in range(3)],
                                        1.0)
    np.testing.assert_array_equal(at.numpy().view(np.uint32), np.asarray(aj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), rtol=1e-6, atol=1e-5)
    assert (np.asarray(aj) >> 16).any() and (np.asarray(cj) == 5).any()


def test_rigid_integration_matches_jax_and_rest_is_bit_exact():
    j = jscenes.sand_box_3d(nxz=4, ny=6, transfer="pallas", by=8)
    jb = jbody.update_world_mass_properties(j.state.bodies)
    tb = body_mod.update_world_mass_properties(
        interop.state_from_reference(j.state, "cpu").bodies)
    dt = float(np.float32(j.params.dt))
    rj, pj = jbody.integrate_velocity(jb, jb.linvel, jb.angvel, jnp.float32(dt))
    rt, pt = body_mod.integrate_velocity(tb, tb.linvel, tb.angvel, dt)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-7)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)
    # The five walls are at rest: pose unchanged bit for bit.
    np.testing.assert_array_equal(rt.numpy()[:5], tb.rot.numpy()[:5])
    np.testing.assert_array_equal(pt.numpy()[:5], tb.pos.numpy()[:5])


def test_main_path_configuration_matches_jax():
    j = jscenes.sand_box_3d(nxz=8, ny=16)
    jd = JMpmData(j.params, j.state.particles, j.state.models, j.bodies_desc,
                  1.0, grid=j.config.grid, transfer="pallas", by=8)
    t = scenes.sand_box_3d(nxz=8, ny=16, by=8, device="cpu")
    jc, tc = jd.config, t.config
    assert tc.grid == interop.config_from_reference(jc).grid
    assert tc.grid.shape == (36, 32, 36) and t.num_particles == 1024
    assert tc.static_slots == jc.static_slots == (0, 1, 2, 3, 4)
    assert jc.dynamic_slots == () and not jc.chan_free and not jc.fold_vel
    assert (tc.max_jobs, tc.n_materials, tc.collider_types) == (
        jc.max_jobs, jc.n_materials, jc.collider_types)
    assert tc == interop.config_from_reference(jc)


@pytest.mark.parametrize("kw", [
    dict(transfer="dense"), dict(sparse=True), dict(chan_free=True),
    dict(fold_vel=True), dict(joints=((0, 5, (0, 0, 0), (0, 0, 0)),)),
    dict(spatial_devices=2)])
def test_unported_options_raise(kw):
    """Each 3D option the port lacks raises naming its ROADMAP item.  The
    chan-free CDF mode, fold_vel, joints, the sparse domain, the dense
    transfer and multi-device sharding are ported now: those cases build
    and carry the option (the joint normalised to a ball joint; the sparse
    domain with the JAX package's kmax and amax defaults, at by 4, the only
    block height it takes; the dense transfer at by 4 with no job table, by
    8 refused as in the JAX package; spatial slabs through
    parallel.spatial_config, as in the JAX package, whose MpmData takes no
    spatial_devices: 2 slabs over 8 x-blocks, 3 refused)."""
    if "joints" in kw:
        d = scenes.sand_box_3d(nxz=4, ny=6, by=8, device="cpu", **kw)
        assert d.config.joints == ((0, 5, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), "ball",
                                    None),)
        return
    if kw == dict(chan_free=True):
        d = scenes.sand_box_3d(nxz=4, ny=6, by=8, device="cpu", **kw)
        assert d.config.chan_free and d.config.static_slots == (0, 1, 2, 3, 4)
        return
    if kw == dict(fold_vel=True):
        d = scenes.sand_box_3d(nxz=4, ny=6, by=8, device="cpu", **kw)
        assert d.config.fold_vel and not d.config.chan_free
        return
    if kw == dict(transfer="dense"):
        d = scenes.sand_box_3d(nxz=4, ny=6, device="cpu", **kw)
        assert d.config.transfer == "dense" and d.config.max_jobs == 0
        with pytest.raises(ValueError, match="pallas"):
            scenes.sand_box_3d(nxz=4, ny=6, by=8, device="cpu", **kw)
        return
    if kw == dict(spatial_devices=2):
        d = scenes.sand_box_3d(nxz=4, ny=6, by=8, device="cpu")
        cfg = spatial_config(d.config, 2)
        assert (cfg.spatial_devices, cfg.migration_cap, cfg.halo_cap) == (2, 2048, 1024)
        assert dataclasses.replace(cfg, spatial_devices=0) == d.config
        with pytest.raises(ValueError, match="divide"):
            spatial_config(d.config, 3)
        with pytest.raises(TypeError):
            scenes.sand_box_3d(nxz=4, ny=6, by=8, device="cpu", **kw)
        return
    if kw == dict(sparse=True):
        d = scenes.sand_box_3d(nxz=4, ny=6, device="cpu", **kw)
        c = d.config
        assert c.sparse and c.kmax == c.max_jobs and c.amax == 4 * c.max_jobs
        assert c.by == 4 and c.amax % 8 == 0
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        scenes.sand_box_3d(nxz=4, ny=6, by=8, device="cpu", **kw)


def test_unported_reference_config_raises():
    """The JAX package's default (dense) configuration comes over now, and
    so do its multi-device fields (spatial_devices, migration_cap,
    halo_cap); an elastic model the port lacks still raises."""
    j = jscenes.sand_box_3d(nxz=4, ny=6)
    assert interop.config_from_reference(j.config).transfer == "dense"
    cfg = interop.config_from_reference(dataclasses.replace(
        j.config, spatial_devices=2, migration_cap=64, halo_cap=32))
    assert (cfg.spatial_devices, cfg.migration_cap, cfg.halo_cap) == (2, 64, 32)
    with pytest.raises(NotImplementedError):
        interop.config_from_reference(dataclasses.replace(j.config,
                                                          elastic_model="hencky"))


def test_sparse_reference_config_is_carried():
    """A JAX sparse configuration comes over with sparse, kmax and amax,
    and equals the port's own construction of the same scene."""
    j = jscenes.sand_box_3d(nxz=4, ny=6, transfer="pallas", sparse=True, kmax=40,
                            amax=100)
    cfg = interop.config_from_reference(j.config)
    assert (cfg.sparse, cfg.kmax, cfg.amax) == (True, 40, 104)
    assert cfg == scenes.sand_box_3d(nxz=4, ny=6, device="cpu", sparse=True, kmax=40,
                                     amax=100).config


@pytest.mark.parametrize("case", ["2d", "by8"])
def test_sparse_refuses_2d_and_by8(case):
    """The sparse domain is 3D-only and takes 4^3 blocks: both packages
    raise ValueError otherwise."""
    if case == "2d":
        calls = (lambda: jscenes.sand_column_2d(nx=4, ny=4, transfer="pallas",
                                                sparse=True),
                 lambda: scenes.sand_column_2d(nx=4, ny=4, device="cpu", sparse=True))
    else:
        calls = (lambda: jscenes.sand_box_3d(nxz=4, ny=6, transfer="pallas",
                                             sparse=True, by=8),
                 lambda: scenes.sand_box_3d(nxz=4, ny=6, device="cpu", sparse=True,
                                            by=8))
    for call in calls:
        with pytest.raises(ValueError, match="sparse"):
            call()


def test_one_way_coupling_reference_config_raises():
    """Per-body coupling is ported now: a one-way body's mode is carried
    over, and with it the spatial decomposition beside it (ported too):
    the configuration equals the port's own spatial_config of the same
    scene."""
    j = jscenes.sand_box_3d(nxz=4, ny=6, transfer="pallas", by=8)
    interop.config_from_reference(j.config)
    one_way = (1,) + tuple(j.config.coupling[1:])
    cfg = interop.config_from_reference(dataclasses.replace(j.config,
                                                            coupling=one_way))
    assert cfg.coupling == one_way and one_way[1:] == (2,) * 5
    both = interop.config_from_reference(dataclasses.replace(
        j.config, coupling=one_way, spatial_devices=2))
    assert both == spatial_config(cfg, 2) and both.coupling == one_way


# Each call builds with no device and returns one tensor it made.
_DEFAULT_DEVICE_CALLS = {
    "sand_box_3d": lambda: scenes.sand_box_3d(nxz=2, ny=2).state.particles.pos,
    "sand_column_2d": lambda: scenes.sand_column_2d(nx=2, ny=2).state.particles.pos,
    "elastic_blocks_2d": lambda: scenes.elastic_blocks_2d(n_side=2).state.bodies.rot,
    "SimulationParams.new": lambda: SimulationParams.new(0.01, [0.0, -9.81]).gravity,
    "Particles.from_arrays": lambda: Particles.from_arrays(
        np.zeros((4, 2)), density=1.0, radius=0.1).mass,
    "Models.from_arrays": lambda: Models.from_arrays(4, 1.0, 1.0).lam,
    "build_rigid_world": lambda: build_rigid_world([]).rot,
    "params_from_reference": lambda: interop.params_from_reference(
        jscenes.sand_column_2d(nx=2, ny=2).params).gravity,
    "probe_inputs": lambda: probe.probe_inputs()[0],
}


@pytest.mark.parametrize("call", sorted(_DEFAULT_DEVICE_CALLS))
def test_default_device_is_the_card(call):
    """Called with no device, a constructor builds on the card; without
    one it raises and never falls back to the CPU."""
    if torch.cuda.is_available():
        assert _DEFAULT_DEVICE_CALLS[call]().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _DEFAULT_DEVICE_CALLS[call]()
