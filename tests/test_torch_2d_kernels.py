"""The 2D path's kernels of the PyTorch port, plain versions, against the
JAX package's Pallas kernels (interpret mode on the CPU) fed the same
inputs: kernels G (particle CDF), H (P2G), I (G2P) and the dim=2 branch of
C (particle update), plus the sort, job table and window moves around
them, on one substep of each small 2D scene in two lattice placements (as
built, and lowered into the floor so that kernel H's impulses carry load)."""

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from wgsparkl_tpu_torch.ops import blocked as bk
from wgsparkl_tpu_torch.ops import rows2d as R2
from wgsparkl_tpu_torch.ops.transfer2d import g2p_rows, p2g_tiles, pcdf_rows
from wgsparkl_tpu_torch.ops.update_rows import update_rows2d
from wgsparkl_tpu_torch.pipeline import _jbody_gate

torch.set_num_threads(2)

CASES = [(s, p) for s in H.SCENES_2D for p in H.SHIFTS_2D]


def _dump(scene, placement):
    return H.jax_dump_2d(scene, H.SHIFTS_2D[placement])


def _jobs(data, d):
    return H.port_jobs(d) + (data.config.grid.cell_width,)


@pytest.mark.parametrize("scene,placement", CASES)
def test_sort_jobs_and_tiles_match_jax_2d(scene, placement):
    data, d = _dump(scene, placement)
    cfg = data.config
    assert not cfg.chan_free and cfg.static_slots == tuple(range(cfg.num_colliders))
    nb = bk.num_blocks(cfg.grid)
    nb_total = int(np.prod(nb))
    npad = d["rows"].shape[1]
    unsorted = H.to_torch(d["unsorted"])
    keys = bk.particle_sort_keys_ch([unsorted[0], unsorted[1]], cfg.grid)
    keys = torch.where(torch.arange(npad) < data.num_particles, keys, nb_total + 1)
    sids, perm = torch.sort(keys, stable=True)
    np.testing.assert_array_equal(sids.numpy(), d["sorted_ids"])
    np.testing.assert_array_equal(perm.numpy(), d["perm"])
    jobs = bk.build_jobs(sids.to(torch.int32), nb_total, cfg.group, cfg.max_jobs)
    live = jobs["len"] > 0
    start = torch.where(live, torch.clamp(jobs["start"], max=npad - cfg.group),
                        npad - cfg.group)
    block = bk.key_to_block(jobs["block"], nb, 2)
    np.testing.assert_array_equal(start.numpy(), d["start"])
    np.testing.assert_array_equal(jobs["len"].numpy(), d["len"])
    np.testing.assert_array_equal(block.numpy(), d["block"])
    bcells = (bk.block_coords_of(block, nb) * 8
              + torch.tensor(cfg.grid.origin_cell)).to(torch.int32)
    np.testing.assert_array_equal(bcells.numpy(), d["bcells"])
    # Window gather of the frame-static channel grid; the two-level gate.
    src = bk.window_sources(block, nb, 4)
    chan = H.to_torch(d["static_chan"]).reshape(nb_total + 1, 64, 4)
    ntiles = bk.gather_tiles(chan, src, R2.WPAD, 4)
    np.testing.assert_array_equal(ntiles.numpy(), d["ntiles"])
    jbody = _jbody_gate(ntiles, R2.WVOL)
    np.testing.assert_array_equal(jbody.numpy(), d["jbody"])
    levels = set(np.unique(d["jbody"][d["len"] > 0]).tolist())
    assert levels == ({0, 2} if placement == "as_built" else levels) and 2 in levels
    # Scatter of the P2G tiles and the gather of grid velocity rows.
    # The card's pull (its plain version) adds in add_rows' order.
    gmm = torch.zeros((nb_total + 1, 64, 3))
    bk.scatter_tiles(gmm, H.to_torch(d["mm"]), src)
    ref = d["grid_mm"].reshape(nb_total + 1, 64, 3)
    np.testing.assert_allclose(gmm.numpy()[..., 2], ref[..., 2], rtol=1e-6,
                               atol=1e-6 * ref[..., 2].max())
    pull = bk.scatter_tiles_pull_plain(torch.full_like(gmm, float("nan")),
                                       H.to_torch(d["mm"]), block, jobs["cum"], nb,
                                       cfg.by)
    np.testing.assert_array_equal(pull.numpy(), gmm.numpy())
    np.testing.assert_allclose(pull.numpy()[..., 2], ref[..., 2], rtol=1e-6,
                               atol=1e-6 * ref[..., 2].max())
    ftiles = bk.gather_tiles(H.to_torch(ref.copy()), src, R2.WPAD, 4)
    np.testing.assert_array_equal(ftiles.numpy(), d["ftiles"])


@pytest.mark.parametrize("scene,placement", CASES)
def test_pcdf2d_matches_jax(scene, placement):
    data, d = _dump(scene, placement)
    cfg = data.config
    out = pcdf_rows(H.to_torch(d["rows"]), H.to_torch(d["ntiles"]),
                    *_jobs(data, d), cfg.group, d["rows"].shape[1],
                    cfg.num_colliders).numpy()
    ce = int(d["covered_end"])
    # Affinity words (split halves): bit for bit.
    np.testing.assert_array_equal(out[[0, 4], :ce], d["pcdf"][[0, 4], :ce])
    assert (d["pcdf"][0, :ce] != 0).sum() > 20
    # Signed distance and normal: a 3x3 MLS solve of 9-node sums, taken in
    # another order by the JAX kernel (sums over the whole window).
    np.testing.assert_allclose(out[1:4, :ce], d["pcdf"][1:4, :ce], rtol=0,
                               atol=5e-4)


@pytest.mark.parametrize("scene,placement", CASES)
def test_p2g2d_matches_jax(scene, placement):
    data, d = _dump(scene, placement)
    mm, imp = p2g_tiles(H.to_torch(d["pdata"]), H.to_torch(d["ntiles"]),
                        H.to_torch(d["btable"]), *_jobs(data, d),
                        data.config.num_colliders)
    # Tiles and impulses: sums over a job's particles in another order
    # (the JAX kernel contracts dense window x group matrices).
    np.testing.assert_allclose(mm.numpy(), d["mm"], rtol=0,
                               atol=2e-6 * np.abs(d["mm"]).max())
    np.testing.assert_allclose(imp.numpy(), d["imp"], rtol=0,
                               atol=1e-5 * max(1.0, np.abs(d["imp"]).max()))
    if placement == "in_floor":
        assert np.abs(d["imp"]).max() > 0.1


@pytest.mark.parametrize("scene,placement", CASES)
def test_g2p2d_matches_jax(scene, placement):
    data, d = _dump(scene, placement)
    krows = g2p_rows(H.to_torch(d["pdata"]), H.to_torch(d["ftiles"]),
                     H.to_torch(d["ntiles"]), H.to_torch(d["btable"]),
                     *_jobs(data, d), data.config.group, d["rows"].shape[1],
                     data.config.num_colliders)
    ce = int(d["covered_end"])
    # PIC velocity and velocity moments: f32 roundoff of 9-node sums.
    np.testing.assert_allclose(krows.numpy()[:6, :ce], d["krows"][:6, :ce],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("scene,placement", CASES)
def test_update_rows2d_matches_jax(scene, placement):
    data, d = _dump(scene, placement)
    cfg = data.config
    nb_total = int(np.prod(bk.num_blocks(cfg.grid)))
    out = update_rows2d(
        H.to_torch(d["rows"]), H.to_torch(d["krows"]), H.to_torch(d["pcdf"]),
        H.to_torch(d["sorted_ids"]), int(d["covered_end"]),
        H.to_torch(d["btable"]), H.to_torch(d["mtable"]),
        float(np.float32(data.params.dt)), cfg.grid.cell_width,
        cfg.num_colliders, cfg.n_materials, nb_total).numpy()
    ref = d["rows_out"]
    for r in (R2.AFF, R2.AFF_SPARE, R2.R_IDS, R2.R_MID):
        np.testing.assert_array_equal(out[r], ref[r])
    affine = list(range(R2.A0, R2.A0 + 4))
    rest = [r for r in range(R2.PCHAN) if r not in affine]
    np.testing.assert_allclose(out[rest], ref[rest], rtol=1e-5, atol=1e-5)
    # The APIC affine rows carry the Kirchhoff stress times V0 D^-1 dt:
    # f32 roundoff in F is amplified by 2 mu (see test_torch_update_jobs).
    scale = np.abs(ref[affine]).max()
    np.testing.assert_allclose(out[affine], ref[affine], rtol=0,
                               atol=5e-3 * scale + 1e-4)
