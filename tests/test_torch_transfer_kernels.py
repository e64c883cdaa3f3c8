"""Kernels A (fused particle CDF + P2G) and B (G2P) of the PyTorch port,
plain versions, against the JAX package's Pallas kernels (interpret mode on
the CPU) fed the same inputs: one substep of the coupled sand box at by=8,
group=256, in three lattice placements that together reach CPIC gate
levels 0, 1 and 2, and the window nodes whose pairs come from all 27
stencil offsets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from wgsparkl_tpu.grid import GridConfig
from wgsparkl_tpu.ops import pallas_cdf
from wgsparkl_tpu_torch.ops import ablation
from wgsparkl_tpu_torch.ops import rows as R
from wgsparkl_tpu_torch.ops.g2p import g2p_rows
from wgsparkl_tpu_torch.ops.p2g_cdf import p2g_cdf_tiles


def _inputs(scene):
    data, d = H.jax_dump(H.SHIFTS[scene])
    jobs, bcells, jbody = H.port_jobs(d)
    cfg = data.config
    common = (H.to_torch(d["btable"]), jobs, bcells, jbody, cfg.grid.cell_width,
              cfg.by, cfg.group, d["rows"].shape[1], cfg.num_colliders,
              H.moving_of(cfg))
    return data, d, common


def test_main_path_config_and_gate_levels():
    """The scene resolves to the main path's configuration, and the three
    placements reach every gate level."""
    data, _ = H.jax_dump(H.SHIFTS["as_built"])
    cfg = data.config
    assert cfg.grid.shape == (36, 32, 36) and data.num_particles == 1024
    assert not cfg.chan_free and not cfg.fold_vel and not cfg.sparse
    assert cfg.static_slots == (0, 1, 2, 3, 4) and cfg.dynamic_slots == ()
    levels = set()
    for scene in H.SHIFTS:
        _, d = H.jax_dump(H.SHIFTS[scene])
        levels |= set(np.unique(d["jbody"][d["len"] > 0]).tolist())
    assert levels == {0, 1, 2}


@pytest.mark.parametrize("scene", sorted(H.SHIFTS))
def test_p2g_cdf_matches_jax(scene):
    _, d, common = _inputs(scene)
    mm, imp, pcdf = p2g_cdf_tiles(H.to_torch(d["rows"][:24]),
                                  H.to_torch(d["ntiles"]), *common)
    ce = int(d["covered_end"])
    pcdf = pcdf.numpy()
    # Affinity words (split halves): bit for bit.
    np.testing.assert_array_equal(pcdf[[0, 5], :ce], d["pcdf"][[0, 5], :ce])
    # Tiles and impulses are sums over a job's particles taken in another
    # order (the JAX kernel contracts dense window x group matrices): f32
    # roundoff relative to the largest entry.
    np.testing.assert_allclose(mm.numpy(), d["mm"], rtol=0,
                               atol=2e-6 * np.abs(d["mm"]).max())
    np.testing.assert_allclose(imp.numpy(), d["imp"], rtol=0,
                               atol=1e-5 * max(1.0, np.abs(d["imp"]).max()))
    # Signed distance and normal: a 4x4 MLS solve of those sums.
    np.testing.assert_allclose(pcdf[1:5, :ce], d["pcdf"][1:5, :ce], rtol=0,
                               atol=5e-4)
    if scene == "on_paddle":
        assert np.abs(d["imp"]).max() > 1.0


def test_p2g_cdf_node_with_all_27_offsets_matches_jax():
    """Kernel A sums each node's pairs offset by offset (the lists order).
    Two jobs of 1024 particles filling their 4 x 8 x 4 blocks at ~8 a cell
    (the P2G ablation probe's construction, with small affine rows) at gate
    level 0: most interior window nodes receive pairs from all 27 stencil
    offsets; their tile rows agree with the JAX kernel under the tolerance of
    test_p2g_cdf_matches_jax."""
    pdata, starts, lens, bcells = ablation.probe_inputs(n=2048, maxj=2, nlive=2,
                                                         device="cpu")
    rng = np.random.default_rng(2)
    pdata[7:16, :2048] = torch.as_tensor(
        rng.normal(size=(9, 2048)).astype(np.float32) * 0.01)
    by, group = ablation.BY, ablation.G
    npad = pdata.shape[1] - group - 128
    wsh, wvol, wpad = R.window_geom(by)
    jobs = {"start": starts, "len": lens}
    jbody = torch.zeros(2, dtype=torch.int32)
    ntiles = torch.zeros((2, wpad, 4))
    btable = torch.zeros((32, 128))
    mm, _, _ = p2g_cdf_tiles(pdata, ntiles, btable, jobs, bcells, jbody, 1.0, by,
                             group, npad, 1, ())
    ref, _, _ = pallas_cdf.p2g_cdf_tiles(
        jnp.asarray(pdata.numpy()), jnp.asarray(ntiles.numpy()),
        jnp.asarray(btable.numpy()),
        {"start": jnp.asarray(starts.numpy()), "len": jnp.asarray(lens.numpy())},
        jnp.asarray(bcells.numpy()),
        GridConfig(shape=(108, 112, 108), cell_width=1.0, origin_cell=(-2, -2, -2)),
        group, npad, 1, jnp.asarray(jbody.numpy()), by=by)
    ref = np.asarray(ref)
    jid, lane = R.job_lanes(jobs)
    _, nidx, valid = R.stencil([pdata[k, lane] for k in range(3)],
                               bcells.to(torch.int64)[jid], R.f32(1.0), wsh)
    reached = torch.zeros((2 * wvol, 27), dtype=torch.bool)
    fi = jid[:, None] * wvol + nidx
    reached[fi[valid], torch.arange(27).expand_as(nidx)[valid]] = True
    full = torch.nonzero(reached.all(1)).flatten()
    assert full.numel() > 20                       # of 48 interior nodes
    j, n = full // wvol, full % wvol
    assert float(mm[j, n, 3].min()) > 0.0
    np.testing.assert_allclose(mm.numpy(), ref, rtol=0, atol=2e-6 * np.abs(ref).max())


@pytest.mark.parametrize("scene", sorted(H.SHIFTS))
def test_g2p_matches_jax(scene):
    _, d, common = _inputs(scene)
    krows = g2p_rows(H.to_torch(d["pdata"]), H.to_torch(d["ftiles"]),
                     H.to_torch(d["ntiles"]), *common)
    ce = int(d["covered_end"])
    # PIC velocity and velocity moments: f32 roundoff of 27-node sums.
    np.testing.assert_allclose(krows.numpy()[:12, :ce], d["krows"][:12, :ce],
                               rtol=0, atol=1e-5)
