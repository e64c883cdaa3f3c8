"""The port's sparse-domain tables against the JAX package's: packed block
keys, the job table and occupied-block table, the active-slot table, slot
lookups, key coordinates and the jobs' octant slots, bit for bit (dead jobs
and table padding included), on random keys from a numpy seed with
sentinels, keys at +-SPARSE_HALF and kmax / amax truncation; the
slot-addressed window moves (window_sources_slots with gather_tiles and
scatter_tiles) against the JAX package's gather_tiles_slots and
scatter_tiles_slots; the slot channel grid against `_sparse_chan_grid`
(distances within 1e-6: XLA:CPU contracts multiply-adds; integers exact);
and the plain slot-addressed mesh pass against `mesh_node_cdf_sparse`
off the edge-plane nodes (ROADMAP queue 3), whose count is printed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_mesh_scenes as M
from wgsparkl_tpu import scenes as jscenes
from wgsparkl_tpu.ops import blocked as jbk
from wgsparkl_tpu.ops import rigid_cdf as jrc
from wgsparkl_tpu.pipeline import MpmData, _sparse_chan_grid
from wgsparkl_tpu.rigid import body as jbody
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch import pipeline as tp
from wgsparkl_tpu_torch.ops import blocked as bk
from wgsparkl_tpu_torch.ops import rigid_cdf as trc

torch.set_num_threads(2)

S = bk.SPARSE_SENTINEL


def test_constants_and_deltas_match_jax():
    assert (bk.SPARSE_HALF, bk.SPARSE_DIM, bk.SPARSE_SENTINEL) == (
        jbk.SPARSE_HALF, jbk.SPARSE_DIM, jbk.SPARSE_SENTINEL)
    assert bk.sparse_octant_deltas() == tuple(jbk.sparse_octant_deltas(3))


def _random_sorted_keys(seed: int, n: int, nblocks: int):
    """n sorted packed keys over nblocks random blocks (digits anywhere in
    [0, SPARSE_DIM - 1), both extremes included), a few out-of-range
    lanes (the sentinel) and a padding tail (sentinel + 1)."""
    rng = np.random.default_rng(seed)
    dig = rng.integers(0, bk.SPARSE_DIM - 1, size=(nblocks, 3))
    dig[0] = 0
    dig[1] = bk.SPARSE_DIM - 2
    dig[2] = (bk.SPARSE_HALF, 0, bk.SPARSE_DIM - 2)
    dig[3] = (bk.SPARSE_HALF - 1, bk.SPARSE_HALF, bk.SPARSE_HALF - 1)
    blocks = (dig[:, 0] * bk.SPARSE_DIM + dig[:, 2]) * bk.SPARSE_DIM + dig[:, 1]
    keys = rng.choice(blocks, size=n - n // 8)
    keys = np.concatenate([keys, np.full(n // 16, S), np.full(n - len(keys) - n // 16,
                                                              S + 1)])
    return np.sort(keys).astype(np.int32)


@pytest.mark.parametrize("seed,n,nblocks,group,max_jobs,kmax,amax", [
    (0, 4096, 40, 64, 192, 192, 768),     # roomy tables
    (1, 4096, 300, 16, 256, 64, 256),     # kmax truncation
    (2, 2048, 30, 64, 128, 128, 24),      # amax truncation
    (3, 8192, 500, 8, 512, 512, 2048),    # job-table overflow
])
def test_tables_match_jax(seed, n, nblocks, group, max_jobs, kmax, amax):
    keys = _random_sorted_keys(seed, n, nblocks)
    jjobs, jok, jnocc = jbk.build_jobs_sparse(jnp.asarray(keys), group, max_jobs, kmax)
    jobs, okeys, n_occ = bk.build_jobs_sparse(torch.as_tensor(keys), group, max_jobs,
                                              kmax)
    for k in ("key", "start", "len"):
        np.testing.assert_array_equal(jobs[k].numpy(), np.asarray(jjobs[k]), err_msg=k)
    assert int(jobs["needed"]) == int(jjobs["needed"])
    np.testing.assert_array_equal(okeys.numpy(), np.asarray(jok))
    assert int(n_occ) == int(jnocc)
    jact, jnact, _ = jbk.sparse_active_table(jok, 3, amax)
    act, n_active = bk.sparse_active_table(okeys, amax)
    np.testing.assert_array_equal(act.numpy(), np.asarray(jact))
    assert int(n_active) == int(jnact)
    deltas = bk.sparse_octant_deltas()
    jt = np.stack([np.asarray(jbk.sparse_slots(jact, jjobs["key"] + dl, amax))
                   for dl in deltas])
    tgts = torch.stack([bk.sparse_slots(act, jobs["key"] + dl, amax) for dl in deltas])
    np.testing.assert_array_equal(tgts.numpy(), jt)
    np.testing.assert_array_equal(bk.sparse_key_coords(jobs["key"]).numpy(),
                                  np.asarray(jbk.sparse_key_coords(jjobs["key"], 3)))
    # Lookups of present, absent and sentinel keys.
    rng = np.random.default_rng(seed + 10)
    q = np.concatenate([np.asarray(jact)[rng.integers(0, amax, 50)],
                        rng.integers(0, S, 50), [S, S + 1, 0]]).astype(np.int32)
    np.testing.assert_array_equal(bk.sparse_slots(act, torch.as_tensor(q), amax).numpy(),
                                  np.asarray(jbk.sparse_slots(jact, jnp.asarray(q), amax)))
    if seed == 1:
        assert int(n_occ) > kmax
    if seed == 2:
        assert int(n_active) > amax
    if seed == 3:
        assert int(jobs["needed"]) > max_jobs


def test_particle_keys_match_jax():
    """Positions across the whole +-SPARSE_HALF block range and past it,
    an off-centre origin, cells of 0.5 (base cells round(p / h) - 1,
    halves to even)."""
    from wgsparkl_tpu.grid import GridConfig as JGrid
    from wgsparkl_tpu_torch.grid import GridConfig

    jg, tg = JGrid((16, 16, 16), 0.5, (-7, 3, 5)), GridConfig((16, 16, 16), 0.5, (-7, 3, 5))
    rng = np.random.default_rng(4)
    span = (bk.SPARSE_HALF + 3) * 4 * tg.cell_width
    pos = rng.uniform(-span, span, size=(3, 5000)).astype(np.float32)
    pos[:, :200] = np.round(pos[:, :200] * 4) / 4     # exact half cells
    jk = np.asarray(jbk.particle_sparse_keys_ch([jnp.asarray(p) for p in pos], jg))
    tk = bk.particle_sparse_keys_ch([torch.as_tensor(p) for p in pos], tg)
    np.testing.assert_array_equal(tk.numpy(), jk)
    assert (jk == S).sum() > 100 and (jk < S).sum() > 1000


def _window_sources_from(tgts: np.ndarray) -> np.ndarray:
    """src[j, w] = tgts[octant(w), j] * 64 + cell(w) for the 6^3 window
    nodes in row-major order, built from scratch."""
    w = np.stack(np.meshgrid(*([np.arange(6)] * 3), indexing="ij"), -1).reshape(-1, 3)
    e = (w >= 4).astype(np.int64)
    c = w - 4 * e
    octant = (e[:, 0] * 2 + e[:, 1]) * 2 + e[:, 2]
    cell = (c[:, 0] * 4 + c[:, 1]) * 4 + c[:, 2]
    return tgts[octant].T.astype(np.int64) * 64 + cell[None, :]


def test_slot_window_moves_match_jax():
    """window_sources_slots against a from-scratch build of the JAX tgts,
    and the gather and scatter it drives against gather_tiles_slots and
    scatter_tiles_slots (which drop the ghost-targeted tiles) on a random
    grid and random tiles."""
    keys = _random_sorted_keys(5, 4096, 60)
    amax, max_jobs = 200, 128
    jjobs, jok, _ = jbk.build_jobs_sparse(jnp.asarray(keys), 64, max_jobs, max_jobs)
    jact, _, _ = jbk.sparse_active_table(jok, 3, amax)
    jt = jnp.stack([jbk.sparse_slots(jact, jjobs["key"] + dl, amax)
                    for dl in jbk.sparse_octant_deltas(3)])
    src = bk.window_sources_slots(torch.as_tensor(np.array(jt)))
    np.testing.assert_array_equal(src.numpy(), _window_sources_from(np.asarray(jt)))
    assert (np.asarray(jt) == amax).any() and (np.asarray(jt) < amax).any()
    rng = np.random.default_rng(6)
    grid = rng.normal(size=(amax + 1, 4, 4, 4, 4)).astype(np.float32)
    grid[amax] = 0.0
    lo, ok = jbk.band_info_slots_chunks(jt, amax, 2048, 8)
    jg = np.asarray(jbk.gather_tiles_slots(jnp.asarray(grid), jt, lo, ok, 3, 2048, 8,
                                           out=(256, 4), c=4))
    tg = bk.gather_tiles(torch.as_tensor(grid).reshape(amax + 1, 64, 4), src, 256, 4)
    np.testing.assert_array_equal(tg.numpy(), jg)
    tiles = rng.normal(size=(max_jobs, 256, 4)).astype(np.float32)
    tiles[:, 216:] = 0.0
    js = np.asarray(jbk.scatter_tiles_slots(jnp.zeros((amax + 1, 4, 4, 4, 4)),
                                            jnp.asarray(tiles), jt, lo, ok, 3, 2048, 8,
                                            win=True))
    ts = bk.scatter_tiles(torch.zeros((amax + 1, 64, 4)), torch.as_tensor(tiles), src)
    ts[amax] = 0.0
    # Each grid row sums its tiles in job order in both: f32 roundoff of
    # the JAX package's three-term selection products only.
    np.testing.assert_allclose(ts.numpy(), js.reshape(amax + 1, 64, 4), rtol=0,
                               atol=1e-5)


def _jax_sparse_scene(**kw) -> MpmData:
    base = jscenes.sand_box_3d(nxz=8, ny=16, cell_width=1.0)
    return MpmData(base.params, base.state.particles, base.state.models,
                   base.bodies_desc, 1.0, grid=base.config.grid, transfer="pallas",
                   group=64, job_chunk=8, sparse=True, **kw)


def _scene_act(jd: MpmData, lowered: float = 0.0):
    """The scene's active table, from its particles' keys (lowered by
    `lowered` cells, into the floor and the paddle)."""
    cfg = jd.config
    p = np.asarray(jd.state.particles.pos) - np.array([0.0, lowered, 0.0], np.float32)
    keys = np.sort(np.asarray(jbk.particle_sparse_keys_ch(
        [jnp.asarray(p[:, a]) for a in range(3)], cfg.grid)))
    _, okeys, _ = jbk.build_jobs_sparse(jnp.asarray(keys), cfg.group, cfg.max_jobs,
                                        cfg.kmax)
    return jbk.sparse_active_table(okeys, 3, cfg.amax)[0]


def test_slot_channel_grid_matches_jax():
    """The slot channel grid of the sand box and its paddle, on the active
    table of its lattice lowered 4 cells into the floor and the paddle:
    aff halves and closest slots exact, distances within 1e-6."""
    jd = _jax_sparse_scene()
    jact = _scene_act(jd, 4.0)
    b = jbody.update_world_mass_properties(jd.state.bodies)
    ref = np.asarray(_sparse_chan_grid(b, None, jd.config, jact, jd.config.amax, 4))
    ref = ref.reshape(jd.config.amax + 1, 64, 4)
    cfg = interop.config_from_reference(jd.config)
    st = interop.state_from_reference(jd.state, "cpu")
    from wgsparkl_tpu_torch.rigid import body as tbody

    got = tp._sparse_chan_grid(tbody.update_world_mass_properties(st.bodies), None, cfg,
                               torch.as_tensor(np.asarray(jact))).numpy()
    np.testing.assert_array_equal(got[..., :3], ref[..., :3])
    np.testing.assert_allclose(got[..., 3], ref[..., 3], rtol=0, atol=1e-6)
    near = got[:-1, :, 2] >= 0
    assert near.sum() > 500 and (got[:-1, :, 0] > 0).sum() > 100
    print(f"{int(near.sum())} slot nodes within a collider's reach")


def _edge_plane(x, verts, prims, rel: float = 1e-6):
    """[M] bool: node positions x [M, 3] on the plane of a triangle's edge
    to rel of the scene's scale, in float64 (torch_mesh_scenes.
    edge_plane_nodes for any node list)."""
    near = np.zeros(len(x), bool)
    for p in np.unique(prims, axis=0):
        v = verts[p]
        n = np.cross(v[1] - v[0], v[2] - v[0])
        for a, b in ((0, 1), (1, 2), (0, 2)):
            e = np.cross(v[b] - v[a], n)
            ap = x - v[a]
            near |= np.abs(ap @ e) <= rel * np.linalg.norm(e) * (
                np.linalg.norm(ap, axis=1) + 1.0)
    return near


def _mesh_passes(jd: MpmData, amax):
    """Both packages' slot-addressed mesh passes of jd's state on an active
    table of every block its samples touch, cut to amax slots (None: no
    cut): (port key, word, JAX key, word) over the amax x 64 slot nodes,
    the active table, amax, and the port's full output's ghost slot."""
    cfg = jd.config
    b = jbody.update_world_mass_properties(jd.state.bodies)
    sw, vw = jrc.world_transform(jd.state.meshes, b)
    keys = np.sort(np.asarray(jbk.particle_sparse_keys_ch(
        [sw[:, a] for a in range(3)], cfg.grid)))
    _, okeys, nocc = jbk.build_jobs_sparse(jnp.asarray(keys), 64, 4096, 4096)
    amax = amax or 8 * int(nocc)
    jact = jbk.sparse_active_table(okeys, 3, amax)[0]
    jk, jasg = jrc.mesh_node_cdf_sparse(jd.state.meshes, b, cfg.grid, cfg.mesh_cids,
                                        cfg.sample_group, cfg.sample_max_jobs,
                                        cfg.sample_chunk, jact, amax)
    m = amax * 64
    jkey = np.asarray(jk)[:-1].reshape(-1).view(np.int32)
    jasg = np.asarray(jasg)[:-1].reshape(m, -1)
    jword = np.zeros(m, np.uint32)
    for i, s in enumerate(cfg.mesh_cids):
        jword |= np.where(jasg[:, 2 * i] > 0, np.uint32(1 << s), np.uint32(0))
        jword |= np.where(jasg[:, 2 * i + 1] > 0, np.uint32(1 << (s + 16)), np.uint32(0))
    mm = jd.state.meshes
    key, word = trc.mesh_node_cdf_sparse(
        *(torch.as_tensor(np.array(x)) for x in (sw, vw, mm.sample_prim, mm.sample_cid)),
        interop.config_from_reference(cfg).grid, torch.as_tensor(np.asarray(jact)), amax)
    key, word = key.numpy(), word.numpy()
    return (key[:m], word[:m], jkey, jword.view(np.int32), np.asarray(jact), amax,
            (key[m:], word[m:]), np.asarray(vw, np.float64), np.asarray(mm.sample_prim))


@pytest.mark.parametrize("amax", [None, 40])
def test_sparse_mesh_pass_matches_jax(amax):
    """The ramp scene's mesh pass on an active table of every block its
    samples touch (amax None) and of that table cut to 40 slots (the nodes
    of the missing blocks dropped in both): keys and words in slot order
    off the edge-plane nodes, distances within 1e-6 x the grid's span; the
    ghost slot stays empty."""
    jd = M.ramp(4, sparse=True)
    key, word, jkey, jword, act, amax, ghost, vw, prims = _mesh_passes(jd, amax)
    assert (ghost[0] == trc.INF_KEY).all() and (ghost[1] == 0).all()
    g = interop.config_from_reference(jd.config).grid
    cells = (bk.sparse_key_coords(torch.as_tensor(act))[:, None, :] * 4
             + torch.tensor(g.origin_cell, dtype=torch.int32)
             + torch.tensor(list(np.ndindex(4, 4, 4)), dtype=torch.int32)[None])
    x = cells.reshape(-1, 3).numpy().astype(np.float64) * g.cell_width
    edge = _edge_plane(x, vw, prims)
    both, differ = M.compare_passes(key, word, jkey, jword, edge)
    np.testing.assert_allclose((key[both] & -16).view(np.float32),
                               (jkey[both] & -16).view(np.float32), rtol=0,
                               atol=1e-6 * M.grid_span(jd))
    fin = int((key < trc.INF_KEY).sum())
    print(f"amax {amax}: {fin} slot nodes with a mesh key, {int(edge.sum())} on an "
          f"edge plane, {differ} of them differ")
    if amax == 40:
        # The cut table holds fewer mesh nodes than the full one.
        assert fin < int((_mesh_passes(jd, None)[0] < trc.INF_KEY).sum())


def test_truncated_blocks_ride_the_last_kept_block():
    """Under occupied-block overflow both packages' job tables give the
    last kept block every lane up to the first out-of-range one: the
    truncated blocks' particles sit in its jobs, under its key, instead of
    in none.  freeze_truncated_blocks cuts the table back to the kept
    blocks' own lanes."""
    keys = np.repeat(np.arange(12, dtype=np.int32) * 7 + 1000, 50)
    keys = np.concatenate([keys, np.full(48, S + 1, np.int32)])
    kmax = 8
    for jobs, okeys in ((bk.build_jobs_sparse(torch.as_tensor(keys), 16, 64, kmax)[:2]),
                        (jbk.build_jobs_sparse(jnp.asarray(keys), 16, 64, kmax)[:2])):
        ln, st, key = (np.asarray(jobs[k]) for k in ("len", "start", "key"))
        live = ln > 0
        assert ln.sum() == 600 and (st + ln)[live].max() == 600
        assert len(np.asarray(okeys)) == kmax
        last = np.asarray(okeys)[-1]
        # The last kept block's own 50 lanes, and the 200 of the 4 truncated.
        assert ln[live & (key == last)].sum() == 250
    # The port's substep cuts that table back to the kept blocks' lanes.
    jobs, okeys, _ = bk.build_jobs_sparse(torch.as_tensor(keys), 16, 64, kmax)
    jobs = bk.freeze_truncated_blocks(jobs, okeys, torch.as_tensor(keys))
    ln = jobs["len"].numpy()
    assert ln.sum() == 400 and ln[jobs["key"].numpy() == last].sum() == 50
    assert (jobs["start"].numpy() + ln)[ln > 0].max() == 400
