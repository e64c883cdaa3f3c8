"""The port's mesh-collider set-up against the JAX package: the surface
sampler (numpy route array for array, the C++ route as a multiset), the
Collider constructors, the configuration MpmData builds for mesh scenes,
interop of the sample cloud, and the two places that must skip mesh slots
(the analytic node CDF and the 2D kernels' collider list)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_scenes as M
import torch_port_helpers as H
from wgsparkl_tpu.collision import cdf_channel as jcch
from wgsparkl_tpu.collision.shapes import Collider as JCollider
from wgsparkl_tpu.rigid import sampling as jsampling
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch.collision import cdf_channel as tcch
from wgsparkl_tpu_torch.collision import shapes as tshp
from wgsparkl_tpu_torch.ops import blocked as bk
from wgsparkl_tpu_torch.ops.p2g_cdf import collider_words
from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc, step_pallas
from wgsparkl_tpu_torch.rigid import sampling as tsampling

torch.set_num_threads(2)


def _heightfield():
    """examples/heightfield3.py's field at its smallest size (16 x 16)."""
    rng = np.random.default_rng(0)
    res = 16
    heights = 0.15 * np.sin(np.linspace(0, 6, res))[:, None] * np.cos(
        np.linspace(0, 6, res))[None, :] + 0.04 * rng.standard_normal((res, res))
    return heights, (24.0, 8.0, 24.0)


def _sine_ground():
    """examples/elastic_cut2.py's 64-vertex sine ground at its smallest size."""
    extent = 48 * 0.2 / 2
    xs = np.linspace(-extent * 1.5, extent * 3.5, 64)
    return np.stack([xs, 0.4 * np.sin(xs * 0.8)], axis=-1)


MESHES = {
    "flat_table": lambda m: m.trimesh(M._flat_table().vertices, M._flat_table().indices),
    "cut3_blade": lambda m: (m.trimesh(M.blade_collider(-2.5, 0.4, 10.0).vertices,
                                       M.blade_collider(-2.5, 0.4, 10.0).indices)),
    "heightfield": lambda m: m.heightfield(*_heightfield()),
    "sine_polyline": lambda m: m.polyline(_sine_ground()),
    "tent_polyline": lambda m: m.polyline(
        np.array([[-4.0, 0.0], [0.0, 1.0], [4.0, 0.0]], np.float32),
        np.array([[0, 1], [1, 2]], np.int32)),
}


@pytest.mark.parametrize("name", list(MESHES))
def test_collider_constructors_match_jax(name):
    j, t = MESHES[name](JCollider), MESHES[name](tshp.Collider)
    assert t.shape_type == j.shape_type and t.shape_type in tshp.MESH
    assert not t.is_analytic and t.params == ()
    np.testing.assert_array_equal(t.vertices, j.vertices)
    np.testing.assert_array_equal(t.indices, j.indices)
    assert t.vertices.dtype == np.float32 and t.indices.dtype == np.int32
    np.testing.assert_array_equal(t.padded_params(), np.zeros(8, np.float32))
    # Arrays in a collider leave the frozen descriptions hashable.
    hash(RigidBodyDesc(t, (0.0,) * t.vertices.shape[1]))


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("cell_width", [0.2, 0.5, 1.0])
def test_sampler_matches_jax(name, cell_width):
    """The numpy route gives JAX's arrays in JAX's order, with the slot and
    the vertex offset applied."""
    col = MESHES[name](JCollider)
    if col.shape_type == tshp.SHAPE_POLYLINE:
        j = jsampling.sample_polyline(col.vertices, col.indices, cell_width, 3, 7)
        t = tsampling.sample_polyline(col.vertices, col.indices, cell_width, 3, 7)
    else:
        j = jsampling.sample_trimesh(col.vertices, col.indices, cell_width, 3, 7,
                                     use_native=False)
        t = tsampling.sample_trimesh(col.vertices, col.indices, cell_width, 3, 7,
                                     use_native=False)
    assert t.count == j.count > 0
    for f in ("points", "primitives", "collider_ids", "vertices", "normals"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
        assert getattr(t, f).dtype == getattr(j, f).dtype
    assert (t.collider_ids == 3).all() and t.primitives.min() >= 7


@pytest.mark.parametrize("name", ["flat_table", "cut3_blade", "heightfield"])
def test_native_sampler_same_multiset(name):
    """The C++ route, built into the port's build directory, gives the
    numpy route's samples as a multiset (4 decimals) and their primitives."""
    assert tsampling._load_native() is not None, "g++ could not build the sampler"
    col = MESHES[name](tshp.Collider)
    s_np = tsampling.sample_trimesh(col.vertices, col.indices, 0.5, use_native=False)
    s_cc = tsampling.sample_trimesh(col.vertices, col.indices, 0.5, use_native=True)
    assert s_np.count == s_cc.count

    def rows(s):
        a = np.concatenate([np.round(s.points, 4), s.primitives.astype(np.float32)], 1)
        return a[np.lexsort(a.T[::-1])]

    np.testing.assert_array_equal(rows(s_np), rows(s_cc))
    assert str(tsampling._BUILD) in str(tsampling._native_lib._name)


def test_heightfield_to_trimesh_matches_jax():
    heights, scale = _heightfield()
    jv, jt = jsampling.heightfield_to_trimesh(heights, scale)
    tv, tt = tsampling.heightfield_to_trimesh(heights, scale)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tt, jt)
    assert len(tt) == 2 * 15 * 15


@pytest.mark.parametrize("make", [M.ramp, lambda: M.ramp(8), M.tent, M.ramp_posed,
                                  M.spinning_paddle, M.blades],
                         ids=["ramp", "ramp_by8", "tent", "ramp_posed", "paddle",
                              "blades"])
def test_config_matches_jax(make):
    """MpmData builds the JAX package's configuration (mesh slots, sample
    job geometry) and the same sample cloud; mesh slots are never static
    and the scene is not chan-free."""
    jd = make()
    cfg = interop.config_from_reference(jd.config)
    td = H.port_data(jd, chan_free=None)
    assert cfg == td.config
    assert cfg.mesh_cids and not set(cfg.mesh_cids) & set(cfg.static_slots)
    assert not td.config.chan_free and not td.config.cdf_chan_free
    assert (cfg.sample_group, cfg.sample_chunk) == (128, 32)
    m = interop.meshes_from_reference(jd.state.meshes, "cpu")
    for f in dataclasses.fields(m):
        a, b = getattr(m, f.name), getattr(td.state.meshes, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape
        if f.name != "sample_local":
            assert torch.equal(a, b), f.name
        else:
            # The JAX scene sampled with its own C++ build (-march=native).
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_meshes_round_trip():
    jd = M.ramp()
    m = interop.meshes_from_reference(jd.state.meshes, "cpu")
    for f in dataclasses.fields(m):
        ref = np.asarray(getattr(jd.state.meshes, f.name))
        got = getattr(m, f.name).numpy()
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    assert m.count == jd.state.meshes.count
    assert interop.meshes_from_reference(None) is None
    st = interop.state_from_reference(jd.state, "cpu")
    assert st.meshes.count == m.count
    assert torch.equal(m.to("cpu").sample_prim, m.sample_prim)


@pytest.mark.parametrize("dim", [2, 3])
def test_chan_free_request_with_mesh_runs_dense(dim):
    """chan_free=True with a mesh slot is kept in the configuration (as the
    JAX package keeps it) and runs the dense mode: the same substep as
    without the request."""
    jd = M.tent() if dim == 2 else M.ramp()
    asked = H.port_data(jd, chan_free=True)
    plain = H.port_data(jd, chan_free=False)
    assert asked.config.chan_free and not asked.config.cdf_chan_free
    jc = interop.config_from_reference(dataclasses.replace(jd.config, chan_free=True))
    assert jc == asked.config
    rec_a, rec_p = {}, {}
    a = step_pallas(asked.state, asked.params, asked.config, 1, record=rec_a)
    p = step_pallas(plain.state, plain.params, plain.config, 1, record=rec_p)
    assert not rec_a["chan_free"]
    assert torch.equal(rec_a["ntiles"], rec_p["ntiles"])
    # The kernels never take a mesh slot.
    with pytest.raises(ValueError, match="mesh"):
        collider_words(((0, tshp.SHAPE_TRIMESH),))
    assert torch.equal(a.particles.pos, p.particles.pos)


def test_dynamic_mesh_body_refused():
    """The JAX package cannot build a dynamic mesh body (no mass
    properties); the port refuses it with a plain message."""
    jd = M.ramp()
    descs = list(H.port_bodies(jd.bodies_desc))
    descs[0] = dataclasses.replace(descs[0], body_type="dynamic")
    with pytest.raises(Exception):
        from wgsparkl_tpu.pipeline import build_rigid_world

        build_rigid_world([dataclasses.replace(jd.bodies_desc[0], body_type="dynamic")], 3)
    st = interop.state_from_reference(jd.state, "cpu")
    with pytest.raises(ValueError, match="mesh collider cannot be dynamic"):
        MpmData(interop.params_from_reference(jd.params, "cpu"), st.particles,
                st.models, descs, 0.5, grid=interop.config_from_reference(
                    jd.config).grid, group=64)


def test_node_cdf_channels_skip_mesh_slots():
    """node_cdf_channels with a mesh slot among collider_types gives the
    analytic slots' triple (the JAX package's), and project still refuses a
    mesh shape asked for directly."""
    jd = M.ramp()
    cfg = interop.config_from_reference(jd.config)
    st = interop.state_from_reference(jd.state, "cpu")
    g = cfg.grid
    pos = bk.block_major_node_positions_ch(g, cfg.by, "cpu")
    b = st.bodies
    got = tcch.node_cdf_channels(cfg.collider_types, b.shape_params, b.rot, b.pos, pos,
                                 g.cell_width)
    only = tcch.node_cdf_channels(cfg.collider_types, b.shape_params, b.rot, b.pos, pos,
                                  g.cell_width, only=frozenset({1}))
    ref = jcch.node_cdf_channels(jd.config.collider_types,
                                 jnp.asarray(b.shape_params.numpy()),
                                 jnp.asarray(b.rot.numpy()), jnp.asarray(b.pos.numpy()),
                                 [jnp.asarray(p.numpy()) for p in pos], g.cell_width)
    for x, y in zip(got, only):
        assert torch.equal(x, y)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert set(np.unique(got[2].numpy())) <= {-1, 1}
    with pytest.raises(ValueError, match="mesh"):
        tcch.project(tshp.SHAPE_TRIMESH, b.shape_params[0], [pos[0], pos[1], pos[2]])


@pytest.mark.parametrize("chan_free", [False, True], ids=["asked_dense", "asked_chan_free"])
def test_2d_substep_with_polyline_and_cuboid(chan_free):
    """A 2D substep with a polyline and a cuboid runs (the kernels take the
    analytic colliders of the mode, none outside chan-free) and matches
    the JAX package's."""
    jd = M.tent()
    td = H.port_data(jd, chan_free=chan_free)
    rec = {}
    out = step_pallas(td.state, td.params, td.config, 1, record=rec)
    assert rec["alldesc"] == () and not rec["chan_free"]
    ref = M._j_step(jd.state, jd.params, jd.config, 1)
    ij, it = np.argsort(np.asarray(ref.particles.ids)), np.argsort(out.particles.ids.numpy())
    np.testing.assert_allclose(out.particles.pos.numpy()[it],
                               np.asarray(ref.particles.pos)[ij], rtol=0, atol=1e-6)
