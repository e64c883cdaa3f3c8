"""The sort, job table, window tile moves and kernel C (fused particle
update) of the PyTorch port against one substep of the JAX main path."""

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from wgsparkl_tpu_torch.ops import blocked as bk
from wgsparkl_tpu_torch.ops import rows as R
from wgsparkl_tpu_torch.ops.update_rows import update_rows
from wgsparkl_tpu_torch.pipeline import _jbody_gate, _moving_reach_gate

torch.set_num_threads(2)


@pytest.mark.parametrize("scene", ["as_built", "on_paddle"])
def test_sort_jobs_and_tiles_match_jax(scene):
    data, d = H.jax_dump(H.SHIFTS[scene])
    cfg = data.config
    grid, by, group = cfg.grid, cfg.by, cfg.group
    nb = bk.num_blocks(grid, by)
    nb_total = int(np.prod(nb))
    npad = d["rows"].shape[1]
    unsorted = H.to_torch(d["unsorted"])
    keys = bk.particle_sort_keys_ch([unsorted[0], unsorted[1], unsorted[2]],
                                    grid, by)
    lane = torch.arange(npad)
    keys = torch.where(lane < data.num_particles, keys, nb_total + 1)
    sids, perm = torch.sort(keys, stable=True)
    np.testing.assert_array_equal(sids.numpy(), d["sorted_ids"])
    np.testing.assert_array_equal(perm.numpy(), d["perm"])

    jobs = bk.build_jobs(sids.to(torch.int32), nb_total, group, cfg.max_jobs)
    live = jobs["len"] > 0
    start = torch.where(live, torch.clamp(jobs["start"], max=npad - group),
                        npad - group)
    np.testing.assert_array_equal(start.numpy(), d["start"])
    np.testing.assert_array_equal(jobs["len"].numpy(), d["len"])
    np.testing.assert_array_equal(jobs["block"].numpy(), d["block"])
    bcells = (bk.block_coords_of(jobs["block"], nb) * torch.tensor((4, by, 4))
              + torch.tensor(grid.origin_cell)).to(torch.int32)
    np.testing.assert_array_equal(bcells.numpy(), d["bcells"])

    # Window gather of the static channel grid and the per-job gate.
    wsh, wvol, wpad = R.window_geom(by)
    src = bk.window_sources(jobs["block"], nb, by)
    chan = H.to_torch(d["static_chan"]).reshape(nb_total + 1, 16 * by, 4)
    ntiles = bk.gather_tiles(chan, src, wpad, 4)
    np.testing.assert_array_equal(ntiles.numpy(), d["ntiles"])
    jbody = _jbody_gate(ntiles, wvol, cfg.static_slots)
    moving = H.moving_of(cfg)
    bodies_rot = H.to_torch(d["btable"][9:13, :cfg.num_colliders].T)

    class _B:  # the pose fields _moving_reach_gate reads, from the table
        rot = bodies_rot
        pos = H.to_torch(d["btable"][13:16, :cfg.num_colliders].T)
        shape_params = H.to_torch(d["btable"][16:24, :cfg.num_colliders].T)

    gate = _moving_reach_gate(bcells, _B, moving, wsh, grid.cell_width)
    jbody = torch.maximum(jbody, torch.where(gate, 2, 0).to(torch.int32))
    np.testing.assert_array_equal(jbody.numpy(), d["jbody"])

    # Scatter of the P2G tiles (index_add_) and the gather of grid rows;
    # the card's pull (its plain version) adds in the same order.
    gmm = torch.zeros((nb_total + 1, 16 * by, 4))
    bk.scatter_tiles(gmm, H.to_torch(d["mm"]), src)
    ref = d["grid_mm"].reshape(nb_total + 1, 16 * by, 4)
    np.testing.assert_allclose(gmm.numpy()[..., 3], ref[..., 3], rtol=1e-6,
                               atol=1e-3)
    pull = bk.scatter_tiles_pull_plain(torch.full_like(gmm, float("nan")),
                                       H.to_torch(d["mm"]), jobs["block"],
                                       jobs["cum"], nb, by)
    np.testing.assert_array_equal(pull.numpy(), gmm.numpy())
    np.testing.assert_allclose(pull.numpy()[..., 3], ref[..., 3], rtol=1e-6,
                               atol=1e-3)
    ftiles = bk.gather_tiles(H.to_torch(ref.copy()), src, wpad, 4)
    np.testing.assert_array_equal(ftiles.numpy(), d["ftiles"])


@pytest.mark.parametrize("scene", ["as_built", "on_paddle"])
def test_update_rows_matches_jax(scene):
    data, d = H.jax_dump(H.SHIFTS[scene])
    cfg = data.config
    nb_total = int(np.prod(bk.num_blocks(cfg.grid, cfg.by)))
    out = update_rows(
        H.to_torch(d["rows"]), H.to_torch(d["krows"]), H.to_torch(d["pcdf"]),
        H.to_torch(d["sorted_ids"]), int(d["covered_end"]),
        H.to_torch(d["btable"]), H.to_torch(d["mtable"]),
        float(np.float32(data.params.dt)), cfg.grid.cell_width,
        cfg.num_colliders, cfg.n_materials, nb_total).numpy()
    ref = d["rows_out"]
    # Affinity halves, ids and material ids: bit for bit.
    for r in (R.AFF, R.AFF_SPARE, R.R_IDS, R.R_MID):
        np.testing.assert_array_equal(out[r], ref[r])
    affine = list(range(R.A0, R.A0 + 9))
    rest = [r for r in range(R.PCHAN) if r not in affine]
    # State rows: f32 roundoff of the same channel math (the XLA CPU code
    # may contract multiply-adds the port keeps apart).
    np.testing.assert_allclose(out[rest], ref[rest], rtol=1e-5, atol=1e-5)
    # The APIC affine rows carry the Kirchhoff stress times V0 D^-1 dt;
    # with 2 mu ~ 1.7e9, f32 roundoff in F after the SVD return map is
    # amplified to ~1e-3 of the largest entry (1e-4 floor for a scene at
    # rest, whose stress is roundoff of near-identity F).
    scale = np.abs(ref[affine]).max()
    np.testing.assert_allclose(out[affine], ref[affine], rtol=0,
                               atol=5e-3 * scale + 1e-4)
