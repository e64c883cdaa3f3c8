"""Foundations of the PyTorch port's 2D path against the JAX package, on the
same numpy-seeded inputs: the signed 2x2 SVD, the 2D Drucker-Prager return
map and corotated stress, unit-complex poses and the 2D body ops, the 2D
cuboid node CDF on tilted walls, 2D row packing, and the 2D sort keys, job
table and window moves."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgsparkl_tpu import scenes as jscenes
from wgsparkl_tpu.collision import cdf_channel as jcch
from wgsparkl_tpu.grid import GridConfig as JGridConfig
from wgsparkl_tpu.math import pose as jpose
from wgsparkl_tpu.math.svd import svd2x2_ch as j_svd2
from wgsparkl_tpu.models import drucker_prager as jdp
from wgsparkl_tpu.models.elasticity import kirchoff_stress_corotated_ch2 as j_stress2
from wgsparkl_tpu.ops import blocked as jbk
from wgsparkl_tpu.ops import pallas_transfer2d as jptf
from wgsparkl_tpu.rigid import body as jbody
from wgsparkl_tpu_torch import interop, scenes
from wgsparkl_tpu_torch.collision import cdf_channel as cch
from wgsparkl_tpu_torch.grid import GridConfig
from wgsparkl_tpu_torch.math import pose
from wgsparkl_tpu_torch.math.svd import svd2x2_ch
from wgsparkl_tpu_torch.models import drucker_prager as dp
from wgsparkl_tpu_torch.models.elasticity import kirchoff_stress_corotated_ch2
from wgsparkl_tpu_torch.ops import blocked as bk
from wgsparkl_tpu_torch.ops import rows2d as R2
from wgsparkl_tpu_torch.parallel import spatial_config
from wgsparkl_tpu_torch.rigid import body as body_mod


KINDS = ("near_identity", "stretched", "inverted", "rank_deficient")


def _fs(kind, seed=0, n=512):
    """2x2 deformation gradients of one kind."""
    rng = np.random.default_rng(seed)
    if kind == "near_identity":
        f = np.eye(2) + 1e-4 * rng.standard_normal((n, 2, 2))
    else:
        f = np.eye(2) + 0.3 * rng.standard_normal((n, 2, 2))
    if kind == "inverted":
        f[:, 0] *= -1.0
    elif kind == "rank_deficient":
        f[:, :, 1] = 0.0
        f[: n // 8] = 0.0                        # F = 0 too
    return f.astype(np.float32)


def _ch(f, lib):
    return {(i, j): lib(f[:, i, j]) for i in range(2) for j in range(2)}


@pytest.mark.parametrize("kind", KINDS)
def test_svd2x2_ch_matches_jax(kind):
    f = _fs(kind)
    uj, sj, vj = j_svd2(_ch(f, jnp.asarray))
    ut, st, vt = svd2x2_ch(_ch(f, torch.as_tensor))
    # Same operations; the JAX rsqrt against the port's IEEE 1/sqrt.
    for a, b in zip(sj, st):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
    # Singular vectors where the singular values are apart: near equal
    # values leave them ill-conditioned (an ulp in P turns V freely).
    apart = np.asarray(sj[0]) - np.abs(np.asarray(sj[1])) > 1e-2
    for mj, mt in ((uj, ut), (vj, vt)):
        for k in range(2):
            for i in range(2):
                np.testing.assert_allclose(mt[k][i].numpy()[apart],
                                           np.asarray(mj[k][i])[apart], atol=1e-5)
    rec = sum(torch.stack(ut[m])[:, None, :] * st[m] * torch.stack(vt[m])[None]
              for m in range(2))                  # [2, 2, n]: U S V^T
    # Reconstruction: the JAX package's own bound for the 2x2 SVD's special
    # cases (tests/test_svd.py) is 2e-4; near identity the polar step loses
    # a few ulps of 1.
    np.testing.assert_allclose(rec.permute(2, 0, 1).numpy(), f, atol=1e-4)
    det = f[:, 0, 0] * f[:, 1, 1] - f[:, 0, 1] * f[:, 1, 0]
    assert (st[0].numpy() >= np.abs(st[1].numpy()) - 1e-6).all()
    assert (np.sign(st[1].numpy())[det < -1e-6] == -1).all()


def test_drucker_prager_2d_matches_jax_and_disabled_is_noop():
    f = np.concatenate([_fs(k, seed=2, n=128) for k in KINDS])
    f = np.eye(2, dtype=np.float32) + 0.05 * (f - np.eye(2, dtype=np.float32))
    n = len(f)
    rng = np.random.default_rng(3)
    params = dp.drucker_prager_arrays([dp.DruckerPrager.new(1.0e7, 0.2)])
    params = {k: np.full(n, v[0], np.float32) for k, v in params.items()}
    params["lam"][::4] = -1.0                    # plasticity disabled
    state = {"det": np.ones(n, np.float32),
             "hardening": rng.uniform(1.0, 2.0, n).astype(np.float32),
             "log_vol_gain": rng.uniform(-0.01, 0.01, n).astype(np.float32)}
    sj, fj = jdp.drucker_prager_project_ch2(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in state.items()}, _ch(f, jnp.asarray))
    st, ft = dp.drucker_prager_project_ch2(
        {k: torch.as_tensor(v) for k, v in params.items()},
        {k: torch.as_tensor(v) for k, v in state.items()}, _ch(f, torch.as_tensor))
    for k in sj:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(st[k].numpy()[::4], state[k][::4])
    moved = 0
    for k in fj:
        np.testing.assert_allclose(ft[k].numpy(), np.asarray(fj[k]), atol=1e-4)
        np.testing.assert_array_equal(ft[k].numpy()[::4], f[::4, k[0], k[1]])
        moved += int((ft[k].numpy() != f[:, k[0], k[1]]).sum())
    assert moved > 0


def test_corotated_stress_2d_matches_jax():
    f = np.concatenate([_fs(k, seed=5, n=128) for k in KINDS])
    lam, mu = 1.0e6, 2.0e6
    tj = j_stress2(lam, mu, _ch(f, jnp.asarray))
    tt = kirchoff_stress_corotated_ch2(lam, mu, _ch(f, torch.as_tensor))
    # An ulp of U, V (the JAX rsqrt against an IEEE 1/sqrt) times lam, 2 mu.
    scale = max(float(np.abs(np.asarray(v)).max()) for v in tj.values())
    for k in tj:
        np.testing.assert_allclose(tt[k].numpy(), np.asarray(tj[k]), rtol=0,
                                   atol=1e-5 * scale)


def test_rot2_poses_match_jax():
    rng = np.random.default_rng(6)
    ang = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
    r1 = rng.standard_normal((64, 2)).astype(np.float32)
    v = rng.standard_normal((64, 2)).astype(np.float32)
    t = rng.standard_normal((64, 2)).astype(np.float32)
    J, T = jnp.asarray, torch.as_tensor
    pairs = [
        (jpose.rot2_from_angle(J(ang)), pose.rot2_from_angle(T(ang))),
        (jpose.rot2_normalize(J(r1)), pose.rot2_normalize(T(r1))),
    ]
    rj, rt = pairs[1]
    pairs += [
        (jpose.rot2_mul(pairs[0][0], rj), pose.rot2_mul(pairs[0][1], rt)),
        (jpose.rotate(rj, J(v)), pose.rotate(rt, T(v))),
        (jpose.inv_rotate(rj, J(v)), pose.inv_rotate(rt, T(v))),
        (jpose.transform_point(rj, J(t), J(v)), pose.transform_point(rt, T(t), T(v))),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)


def test_rigid_body_ops_2d_match_jax_and_rest_is_bit_exact():
    j = jscenes.elastic_blocks_2d(n_side=8, cell_width=0.5, transfer="pallas",
                                  group=128)
    jb = jbody.update_world_mass_properties(j.state.bodies)
    tb = body_mod.update_world_mass_properties(
        interop.state_from_reference(j.state, "cpu").bodies)
    np.testing.assert_array_equal(tb.world_com.numpy(), np.asarray(jb.world_com))
    assert tb.rot.shape == (3, 2) and tb.angvel.shape == (3, 1)
    dt = float(np.float32(j.params.dt))
    # The three walls are at rest: pose unchanged bit for bit.
    rt, pt = body_mod.integrate_velocity(tb, tb.linvel, tb.angvel, dt)
    np.testing.assert_array_equal(rt.numpy(), tb.rot.numpy())
    np.testing.assert_array_equal(pt.numpy(), tb.pos.numpy())
    # Moving: impulses through a unit inverse mass and inertia, then a pose
    # step of the tilted walls.
    rng = np.random.default_rng(7)
    lin = rng.standard_normal((3, 2)).astype(np.float32)
    ang = rng.standard_normal((3, 1)).astype(np.float32)
    jb = jb.replace(inv_mass=jnp.ones((3, 2)), inv_inertia_world=jnp.ones((3, 1, 1)))
    tb.inv_mass[:] = 1.0
    tb.inv_inertia_world[:] = 1.0
    lj, aj = jbody.apply_impulse(jb, jnp.asarray(lin), jnp.asarray(ang))
    lt, at = body_mod.apply_impulse(tb, torch.as_tensor(lin), torch.as_tensor(ang))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    rj, pj = jbody.integrate_velocity(jb, lj, aj, jnp.float32(dt))
    rt, pt = body_mod.integrate_velocity(tb, lt, at, dt)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-7)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-6)
    assert (rt.numpy() != tb.rot.numpy()).any()


def test_cuboid_node_cdf_2d_on_tilted_walls_matches_jax():
    j = jscenes.elastic_blocks_2d(n_side=24, cell_width=0.5, transfer="pallas",
                                  group=128)
    b = j.state.bodies
    rng = np.random.default_rng(8)
    pos = rng.uniform([-16, -1.5], [16, 8], (20000, 2)).astype(np.float32)
    pos[:6000, 1] = rng.uniform(-0.5, 1.0, 6000)     # around the floor top
    types = j.config.collider_types
    dj, aj, cj = jcch.node_cdf_channels(types, b.shape_params, b.rot, b.pos,
                                        [jnp.asarray(pos[:, a]) for a in range(2)],
                                        0.5)
    t = interop.state_from_reference(j.state, "cpu").bodies
    dt_, at, ct = cch.node_cdf_channels(types, t.shape_params, t.rot, t.pos,
                                        [torch.as_tensor(pos[:, a]) for a in range(2)],
                                        0.5)
    np.testing.assert_array_equal(at.numpy().view(np.uint32), np.asarray(aj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), rtol=1e-6, atol=1e-5)
    # Every collider is somebody's closest, inside bits included.
    assert set(np.unique(np.asarray(cj)).tolist()) >= {0, 1, 2}
    assert (np.asarray(aj) >> 16).any()


def test_row_packing_2d_matches_jax():
    j = jscenes.sand_column_2d(nx=8, ny=12, cell_width=0.5, transfer="pallas",
                               group=128)
    st = j.state
    rng = np.random.default_rng(9)
    n = st.particles.count
    aff = rng.integers(0, 2 ** 32, n, dtype=np.uint32)
    p = st.particles.replace(
        affine=jnp.asarray(rng.standard_normal((n, 2, 2)), jnp.float32),
        cdf_affinity=jnp.asarray(aff),
        cdf_normal=jnp.asarray(rng.standard_normal((n, 2)), jnp.float32))
    jst = st.replace(particles=p)
    t = interop.state_from_reference(jst, "cpu")
    rows = R2.pack_rows_padded(t.particles, t.models, 2048)
    np.testing.assert_array_equal(
        rows.numpy(), np.asarray(jptf.pack_rows_padded(p, jst.models, 2048)))
    p2, m2 = R2.unpack_state_rows(rows[:, :n], t.particles, t.models)
    for f in ("pos", "vel", "def_grad", "affine", "cdf_affinity", "cdf_normal",
              "ids", "init_volume", "mass"):
        np.testing.assert_array_equal(getattr(p2, f).numpy(),
                                      getattr(t.particles, f).numpy())
    np.testing.assert_array_equal(m2.mat_id.numpy(), t.models.mat_id.numpy())


def test_sort_keys_jobs_and_windows_2d_match_jax():
    grid = GridConfig.from_bounds(np.array([-20.0, -0.5]), np.array([20.0, 30.0]),
                                  0.5)
    jgrid = JGridConfig.from_bounds(np.array([-20.0, -0.5]),
                                    np.array([20.0, 30.0]), 0.5)
    assert grid.shape == tuple(jgrid.shape) and grid.shape[0] % 8 == 0
    rng = np.random.default_rng(10)
    pos = rng.uniform([-25, -2], [25, 32], (6000, 2)).astype(np.float32)
    pos[:2000] = rng.uniform([-3, 0], [3, 6], (2000, 2))       # crowded blocks
    pos[2000:2100] = np.round(pos[2000:2100] * 4.0) / 4.0      # half-cell ties
    keys_t = bk.particle_sort_keys_ch([torch.as_tensor(pos[:, a]) for a in range(2)],
                                      grid)
    keys_j = jbk.particle_sort_keys_ch([jnp.asarray(pos[:, a]) for a in range(2)],
                                       jgrid)
    np.testing.assert_array_equal(keys_t.numpy(), np.asarray(keys_j))
    nb = bk.num_blocks(grid)
    nb_total = int(np.prod(nb))
    assert (keys_t.numpy() == nb_total).any()                  # out of grid
    sids = torch.sort(keys_t, stable=True).values.to(torch.int32)
    jobs_t = bk.build_jobs(sids, nb_total, 64, 512)
    jobs_j = jbk.build_jobs(jnp.asarray(sids.numpy()), nb_total, 64, 512)
    for k in ("start", "len", "block", "needed"):
        np.testing.assert_array_equal(jobs_t[k].numpy(), np.asarray(jobs_j[k]))
    block_t = bk.key_to_block(jobs_t["block"], nb, 2)
    block_j = jbk.key_to_block(jobs_j["block"], nb, 2)
    np.testing.assert_array_equal(block_t.numpy(), np.asarray(block_j))
    np.testing.assert_array_equal(bk.block_coords_of(block_t, nb).numpy(),
                                  np.asarray(jbk.block_coords_of(block_j, nb)))
    np.testing.assert_array_equal(bk.neighbor_block_table(nb),
                                  jbk.neighbor_block_table(nb))
    # Window gather of a grid of distinct values: the JAX octant slices.
    vals = rng.standard_normal((nb_total + 1, 8, 8, 3)).astype(np.float32)
    vals[-1] = 0.0
    src = bk.window_sources(block_t, nb, 4)
    tiles_t = bk.gather_tiles(torch.as_tensor(vals).reshape(nb_total + 1, 64, 3),
                              src, R2.WPAD, 3)
    tiles_j = jbk.gather_tiles(jnp.asarray(vals), block_j,
                               jnp.asarray(jbk.neighbor_block_table(nb)), 2)
    np.testing.assert_array_equal(tiles_t.numpy()[:, :R2.WVOL],
                                  np.asarray(tiles_j).reshape(-1, R2.WVOL, 3))
    # Node positions in block-major storage order.
    node = bk.block_major_node_positions_ch(grid, 4, "cpu")
    cells = (np.stack(np.meshgrid(np.arange(8), np.arange(8), indexing="ij"), -1)
             .reshape(64, 2))
    coords = bk.block_coords_of(torch.arange(nb_total), nb).numpy()
    ref = ((coords[:, None, :] * 8 + cells[None] + np.asarray(grid.origin_cell))
           .astype(np.float32) * np.float32(0.5)).reshape(-1, 2)
    for a in range(2):
        np.testing.assert_array_equal(node[a].numpy(), ref[:, a])


@pytest.mark.parametrize("dim", [2, 3])
def test_stencil_drops_window_edge_nodes_like_jax(dim):
    """At cell width 0.2, p * (1/h) can round below the p / h of the block
    sort key: the stencil base then lies one node below the window, and
    that node is dropped (the JAX window weight rows drop it) instead of
    wrapping to another window node."""
    from wgsparkl_tpu.ops import pallas_transfer as jptf3
    from wgsparkl_tpu_torch.ops import rows as R

    h = np.float32(0.2)
    rng = np.random.default_rng(11)
    k = rng.integers(-200, 200, 200_000)
    q = ((k + 0.5) * 0.2).astype(np.float32)                 # near half cells
    q = np.concatenate([q, np.nextafter(q, np.float32(1e9)),
                        np.nextafter(q, np.float32(-1e9))])
    key_base = torch.round(torch.as_tensor(q) / float(h)).numpy().astype(np.int64) - 1
    low = np.floor(q * (np.float32(1.0) / h) + np.float32(0.5)) - 1 < key_base
    q = q[low][:16]
    assert len(q) == 16
    g = len(q)
    pos = np.stack([q] + [rng.uniform(-5, 5, g).astype(np.float32)
                          for _ in range(dim - 1)])
    bcell = np.stack([np.round(pos[a] / h).astype(np.int64) - 1
                      for a in range(dim)], axis=1)        # the sort-key base
    inv_h = float(np.float32(1.0) / h)
    pt = [torch.as_tensor(pos[a]) for a in range(dim)]
    if dim == 2:
        w, nidx, valid = R.stencil(pt, torch.as_tensor(bcell), inv_h, R2.WSH)
        wvol = R2.WVOL
    else:
        wvol = 216
        w, nidx, valid = R.stencil(pt, torch.as_tensor(bcell), inv_h, (6, 6, 6))
    assert not valid[:, :3 ** (dim - 1)].any()              # base row dropped
    dense = torch.zeros((g, wvol)).scatter_add_(1, nidx, w).numpy()
    for i in range(g):                     # the JAX function takes one job cell
        args = (jnp.asarray(pos[:, i:i + 1]), jnp.asarray(bcell[i], jnp.int32), 0.2,
                jnp.ones(1))
        ref = (jptf._window_w(*args) if dim == 2
               else jptf3._window_w(*args, wsh=(6, 6, 6), wpad=216))
        np.testing.assert_array_equal(dense[i], np.asarray(ref)[:wvol, 0])


def _moving_floor_2d(**kw):
    """A 2D lattice over a kinematic (moving) floor."""
    from wgsparkl_tpu_torch.collision.shapes import Collider
    from wgsparkl_tpu_torch.params import SimulationParams
    from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc
    from wgsparkl_tpu_torch.solver import Models, Particles

    pos = np.stack(np.meshgrid(np.arange(4.0), np.arange(4.0) + 1.0), -1).reshape(-1, 2)
    return MpmData(
        SimulationParams.new(0.001, [0.0, -9.81], device="cpu"),
        Particles.from_arrays(pos * 0.25, density=1000.0, radius=0.125, device="cpu"),
        Models.from_arrays(16, 1.0e6, 1.0e6, device="cpu"),
        [RigidBodyDesc(Collider.cuboid(8.0, 1.0), (0.0, -1.0), body_type="kinematic",
                       linvel=(0.5, 0.0))], 0.5, **kw)


def _chan_free_2d():
    return scenes.sand_column_2d(nx=4, ny=4, cell_width=0.5, device="cpu",
                                 chan_free=True)


def _fold_vel_2d():
    return scenes.sand_column_2d(nx=4, ny=4, cell_width=0.5, device="cpu",
                                 fold_vel=True)


def _spatial_2d():
    """The column's 3 x-blocks split in 3 slabs through spatial_config (2
    do not divide them and raise), as in the JAX package."""
    d = scenes.sand_column_2d(nx=4, ny=4, cell_width=0.5, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        spatial_config(d.config, 2)
    d.config = spatial_config(d.config, 3)
    return d


_PORTED_2D = {_chan_free_2d: "chan_free", _fold_vel_2d: "fold_vel",
              _spatial_2d: "spatial_devices"}


@pytest.mark.parametrize("make", [
    _chan_free_2d,
    None,
    _fold_vel_2d,
    _spatial_2d,
    _moving_floor_2d,
], ids=["chan_free", "neo_hookean", "fold_vel", "spatial", "moving_collider"])
def test_unported_2d_options_raise(make):
    """Each 2D option the port lacks raises naming its ROADMAP item.  2D
    neo-Hookean, 2D moving colliders, the 2D chan-free CDF mode, fold_vel
    and spatial slabs are ported now: those cases build and carry the
    model, the moving slot or the option."""
    if make in _PORTED_2D:
        d = make()
        assert getattr(d.config, _PORTED_2D[make])
        return
    if make is None:
        d = scenes.sand_column_2d(nx=4, ny=4, cell_width=0.5, device="cpu",
                                  elastic_model="neo_hookean")
        assert d.config.elastic_model == "neo_hookean"
        return
    if make is _moving_floor_2d:
        d = make()
        assert not d.config.chan_free
        assert d.config.static_slots == () and d.config.num_colliders == 1
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make()
