"""Kernels A (fused particle CDF + P2G) and B (G2P) of the PyTorch port,
plain versions, against the JAX package's Pallas kernels (interpret mode on
the CPU) fed the same inputs: one substep of the analytic-shapes scene
(a static halfspace and four walls, a kinematic capsule paddle and a
kinematic ball) in the gathered-hybrid and the chan-free CDF modes, in
three lattice placements (on the capsule, on the ball, aside on the
floor)."""

import functools

import numpy as np
import pytest

import torch_port_helpers as H
from wgsparkl_tpu_torch.ops.g2p import g2p_rows
from wgsparkl_tpu_torch.ops.p2g_cdf import p2g_cdf_tiles


MODES = {"gathered": False, "chan_free": True}
CASES = [(m, s) for m in sorted(MODES) for s in sorted(H.SHIFTS_SHAPES)]


@functools.lru_cache(maxsize=None)
def _dump(mode, scene):
    return H.dump_phases(H.jax_scene_shapes(H.SHIFTS_SHAPES[scene], MODES[mode]),
                         substeps_before=1)


def _inputs(mode, scene):
    data, d = _dump(mode, scene)
    jobs, bcells, jbody = H.port_jobs(d)
    cfg = data.config
    assert cfg.chan_free is MODES[mode]
    common = (H.to_torch(d["btable"]), jobs, bcells, jbody, cfg.grid.cell_width,
              cfg.by, cfg.group, d["rows"].shape[1], cfg.num_colliders,
              H.moving_of(cfg), H.static_of(cfg), cfg.chan_free)
    return d, common


def test_gate_levels_of_both_modes():
    """Both modes reach every gate level (level 1: only the static
    halfspace in reach); chan-free gathers no tile."""
    levels = {m: set() for m in MODES}
    for mode, scene in CASES:
        _, d = _dump(mode, scene)
        levels[mode] |= set(np.unique(d["jbody"][d["len"] > 0]).tolist())
        if MODES[mode]:
            assert d["ntiles"].shape[0] == 1          # no tile gathered
    assert levels["chan_free"] == levels["gathered"] == {0, 1, 2}


@pytest.mark.parametrize("mode,scene", CASES)
def test_p2g_cdf_shapes_match_jax(mode, scene):
    d, common = _inputs(mode, scene)
    mm, imp, pcdf = p2g_cdf_tiles(H.to_torch(d["rows"][:24]),
                                  H.to_torch(d["ntiles"]), *common)
    ce = int(d["covered_end"])
    pcdf = pcdf.numpy()
    # Affinity words (split halves): bit for bit.
    np.testing.assert_array_equal(pcdf[[0, 5], :ce], d["pcdf"][[0, 5], :ce])
    # Sums over a job's particles in another order than the JAX kernel's
    # dense window x group products: f32 roundoff of the largest entry.
    np.testing.assert_allclose(mm.numpy(), d["mm"], rtol=0,
                               atol=2e-6 * np.abs(d["mm"]).max())
    np.testing.assert_allclose(imp.numpy(), d["imp"], rtol=0,
                               atol=1e-5 * max(1.0, np.abs(d["imp"]).max()))
    np.testing.assert_allclose(pcdf[1:5, :ce], d["pcdf"][1:5, :ce], rtol=0,
                               atol=5e-4)
    if scene != "aside":
        assert np.abs(d["imp"]).max() > 1.0


@pytest.mark.parametrize("mode,scene", CASES)
def test_g2p_shapes_match_jax(mode, scene):
    d, common = _inputs(mode, scene)
    krows = g2p_rows(H.to_torch(d["pdata"]), H.to_torch(d["ftiles"]),
                     H.to_torch(d["ntiles"]), *common)
    ce = int(d["covered_end"])
    # PIC velocity and velocity moments: f32 roundoff of 27-node sums.
    np.testing.assert_allclose(krows.numpy()[:12, :ce], d["krows"][:12, :ce],
                               rtol=0, atol=1e-5)
