"""The port's mesh node-CDF pass and node CDF against the JAX package.

mesh_node_cdf (its plain version, which the card holds the mesh_cdf kernel
to bit for bit) against the JAX package's rigid_cdf.mesh_node_cdf on the
same samples and poses: 3D at by 4 and by 8, 2D, a rotated kinematic pose
and a mesh reaching past the grid's edges.  Tolerance: distances within
1e-6 (XLA:CPU may contract the dots and crosses to multiply-adds; nodes on
an edge plane (the inside test an exact zero) may then flip either way:
they are counted and printed, the blades scene has some), collider ids,
finite nodes and affinity words equal off those nodes.  Then _node_cdf_full (analytic
colliders merged with the mesh pass) against the JAX package's, and the
world transform of samples and vertices."""

import types

import numpy as np
import pytest
import torch

import torch_mesh_scenes as M
from wgsparkl_tpu.ops import rigid_cdf as jrc
from wgsparkl_tpu.pipeline import _node_cdf_full as j_node_cdf_full
from wgsparkl_tpu.pipeline import _node_cdf_static as j_node_cdf_static
from wgsparkl_tpu.rigid import body as jbody
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch import pipeline as tp
from wgsparkl_tpu_torch.ops import rigid_cdf as trc
from wgsparkl_tpu_torch.rigid import body as tbody

torch.set_num_threads(2)

PASS_SCENES = {
    "3d_by4": M.ramp,
    "3d_by8": lambda: M.ramp(8),
    "2d": M.tent,
    "posed_kinematic": M.ramp_posed,
    "past_grid_edge": lambda: M.table(half=8.0),
    "blades": M.blades,
}


@pytest.mark.parametrize("scene", list(PASS_SCENES))
def test_mesh_pass_matches_jax(scene):
    jd = PASS_SCENES[scene]()
    nodes, differ = M.check_pass(jd)
    print(f"{scene}: {nodes} mesh nodes, {differ} edge-plane nodes differ")
    if scene != "blades":
        assert differ == 0
    if scene == "past_grid_edge":
        # Samples outside the grid: the pass still fills the edge nodes.
        st = interop.state_from_reference(jd.state, "cpu")
        cfg = interop.config_from_reference(jd.config)
        sw, _ = trc.world_transform(st.meshes, st.bodies)
        lo = np.asarray(cfg.grid.origin_cell) * cfg.grid.cell_width
        hi = lo + (np.asarray(cfg.grid.shape) - 1) * cfg.grid.cell_width
        out = ((sw.numpy() < lo) | (sw.numpy() > hi)).any(1)
        assert out.sum() > 100 and (~out).sum() > 100


def test_mesh_pass_after_motion_matches_jax():
    """The kinematic ramp after 5 substeps of motion: both packages' mesh
    passes at the moved pose."""
    jd = M.ramp_posed()
    ref = M._j_step(jd.state, jd.params, jd.config, 5)
    moved = types.SimpleNamespace(config=jd.config, state=ref)
    assert not np.array_equal(np.asarray(ref.bodies.rot), np.asarray(jd.state.bodies.rot))
    assert M.check_pass(moved)[1] == 0


@pytest.mark.parametrize("scene", ["ramp", "tent", "posed"])
def test_world_transform_matches_jax(scene):
    jd = {"ramp": M.ramp, "tent": M.tent, "posed": M.ramp_posed}[scene]()
    st = interop.state_from_reference(jd.state, "cpu")
    sw, vw = trc.world_transform(st.meshes, st.bodies)
    jsw, jvw = jrc.world_transform(jd.state.meshes, jd.state.bodies)
    np.testing.assert_allclose(sw.numpy(), np.asarray(jsw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(vw.numpy(), np.asarray(jvw), rtol=0, atol=1e-6)
    assert sw.is_contiguous() and vw.is_contiguous()


def test_plain_pass_on_a_known_table():
    """The flat table at y = 0: nodes above and below the table within the
    stencil reach get |y| and slot 0, and the sign bit only below."""
    jd = M.table()
    key, word = M.port_pass(jd)
    cfg = interop.config_from_reference(jd.config)
    from wgsparkl_tpu_torch.ops import blocked as bk

    pos = [p.numpy() for p in bk.block_major_node_positions_ch(cfg.grid, cfg.by, "cpu")]
    fin = key < trc.INF_KEY
    assert fin.sum() > 100
    dist = (key & -16).view(np.float32)
    np.testing.assert_allclose(dist[fin], np.abs(pos[1][fin]), rtol=0, atol=1e-6)
    assert ((key[fin] & 15) == 0).all() and ((word[fin] & 1) == 1).all()
    below = fin & (pos[1] < 0)
    assert below.any()
    assert ((word[below] >> 16) & 1 == 1).all()
    assert ((word[fin & (pos[1] > 0)] >> 16) & 1 == 0).all()
    assert (word[~fin] == 0).all()


def _triples(jd, static_part: bool):
    cfg = interop.config_from_reference(jd.config)
    st = interop.state_from_reference(jd.state, "cpu")
    tb = tbody.update_world_mass_properties(st.bodies)
    jb = jbody.update_world_mass_properties(jd.state.bodies)
    ts = tp._node_cdf_static(tb, cfg) if static_part else None
    js = j_node_cdf_static(jb, jd.config, block_major=True) if static_part else None
    t = tp._node_cdf_full(tb, cfg, ts, st.meshes)
    j = j_node_cdf_full(jd.state, jb, jd.config, block_major=True, static_part=js)
    return t, j


@pytest.mark.parametrize("scene,static_part", [("table", False), ("ramp", False),
                                               ("ramp", True), ("tent", True),
                                               ("blades", True)])
def test_node_cdf_full_matches_jax(scene, static_part):
    """The analytic colliders' node CDF merged with the mesh pass: distances
    within 1e-6 x the grid's largest coordinate (XLA:CPU's multiply-adds,
    see torch_mesh_scenes.compare_passes), affinity words
    and closest slots equal, off the mesh's edge-plane nodes (see
    test_mesh_pass_matches_jax)."""
    jd = {"table": M.table, "ramp": M.ramp, "tent": M.tent, "blades": M.blades}[scene]()
    (dist, aff, closest), (jdist, jaff, jclosest) = _triples(jd, static_part)
    off = ~M.edge_plane_nodes(jd)
    np.testing.assert_allclose(dist.numpy()[off], np.asarray(jdist)[off], rtol=0,
                               atol=1e-6 * M.grid_span(jd))
    np.testing.assert_array_equal(aff.numpy().view(np.uint32)[off], np.asarray(jaff)[off])
    np.testing.assert_array_equal(closest.numpy()[off], np.asarray(jclosest)[off])
    assert (aff.numpy()[off] != 0).sum() > 10
    cfg = jd.config
    assert set(cfg.mesh_cids) <= set(np.unique(closest.numpy()).tolist())
    if scene != "table":
        assert (set(range(len(cfg.collider_types))) - set(cfg.mesh_cids)) & set(
            np.unique(closest.numpy()).tolist())
