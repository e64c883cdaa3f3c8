"""JAX package scenes with mesh colliders for the tests that hold the port's
mesh colliders against the JAX package, at the sizes of
tests/test_mesh_colliders.py, and the runners that step both packages or
take the mesh pass of both apart."""

from __future__ import annotations

import dataclasses
import types

import jax
import numpy as np
import torch

from test_mesh_colliders import _flat_table, _mesh_scene
from wgsparkl_tpu import scenes
from wgsparkl_tpu.collision.shapes import Collider
from wgsparkl_tpu.models import ElasticCoefficients
from wgsparkl_tpu.ops import rigid_cdf as jrc
from wgsparkl_tpu.params import SimulationParams
from wgsparkl_tpu.pipeline import MpmData, RigidBodyDesc
from wgsparkl_tpu.pipeline import step_pallas as j_step
from wgsparkl_tpu.rigid import body as jbody
from wgsparkl_tpu.solver import Models, Particles
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch.ops import rigid_cdf as trc
from wgsparkl_tpu_torch.pipeline import step_pallas

_j_step = jax.jit(j_step, static_argnums=(2, 3))


def ramp(by: int = 4, **kw) -> MpmData:
    """The mixed ramp + cuboid floor scene of test_mesh_colliders.py on the
    bounded pallas path (group 64)."""
    return _mesh_scene("pallas", extra=dict(by=by, **kw))


def ramp_posed(by: int = 4) -> MpmData:
    """The ramp's trimesh on a rotated, translated kinematic body that spins
    and drifts, beside the static cuboid floor."""
    d = ramp(by)
    descs = list(d.bodies_desc)
    descs[0] = dataclasses.replace(descs[0], translation=(0.3, 0.4, -0.2),
                                   rotation=(0.2, 0.3, 0.1), body_type="kinematic",
                                   linvel=(0.0, 0.1, 0.0), angvel=(0.0, 0.5, 0.3))
    return MpmData(d.params, d.state.particles, d.state.models, descs, 0.5,
                   grid=d.config.grid, transfer="pallas", group=64, job_chunk=8,
                   by=by)


def table(half: float = 5.0, bounds: float = 4.0, y: float = 2.0) -> MpmData:
    """A single particle above the flat two-triangle table (test_node_cdf_
    from_trimesh's scene) on the pallas path; half: the table's
    half-width (8 reaches past the grid's edges), bounds: the grid's."""
    h = 0.5
    col = _flat_table(h)
    if half != 5.0:
        col = Collider.trimesh(col.vertices * np.float32(half / 5.0), col.indices)
    pos = np.array([[0.0, y, 0.0]], np.float32)
    parts = Particles.from_arrays(pos, density=1000.0, radius=h / 4)
    m = ElasticCoefficients.from_young_modulus(1e6, 0.2)
    models = Models.from_arrays(1, m.lam, m.mu, phase=1.0)
    params = SimulationParams.new(dt=1 / 600, gravity=[0, -9.81, 0])
    return MpmData(params, parts, models, [RigidBodyDesc(col, (0.0, 0.0, 0.0))],
                   cell_width=h, grid_bounds=(np.array([-bounds, -2.0, -bounds]),
                                              np.array([bounds, 4.0, bounds])),
                   transfer="pallas", group=64, job_chunk=8)


def tent(**kw) -> MpmData:
    """The 2D polyline tent + cuboid floor of test_mesh_colliders.py
    (test_mesh_collider_paths_agree_2d) on the pallas path."""
    h = 0.5
    verts = np.array([[-4.0, 0.0], [0.0, 1.0], [4.0, 0.0]], np.float32)
    poly = Collider.polyline(verts, np.array([[0, 1], [1, 2]], np.int32))
    xs = np.arange(10) * h / 2 + h / 4
    g = np.meshgrid(xs - 1.25, xs + 1.2, indexing="ij")
    pos = np.stack([a.ravel() for a in g], -1).astype(np.float32)
    parts = Particles.from_arrays(pos, density=1000.0, radius=h / 4)
    m = ElasticCoefficients.from_young_modulus(1e6, 0.2)
    models = Models.from_arrays(len(pos), m.lam, m.mu, phase=1.0)
    params = SimulationParams.new(dt=1 / 600, gravity=[0, -9.81])
    return MpmData(params, parts, models,
                   [RigidBodyDesc(poly, (0.0, 0.0)),
                    RigidBodyDesc(Collider.cuboid(6.0, 0.5), (0.0, -1.2))],
                   cell_width=h, grid_bounds=(np.array([-4.0, -2.0]),
                                              np.array([4.0, 6.0])),
                   transfer="pallas", group=64, job_chunk=8, **kw)


PADDLE_VERTS = np.array([[0.0, -2.0, -6.0], [0.0, -2.0, 6.0], [0.0, 2.0, 6.0],
                         [0.0, 2.0, -6.0]], np.float32)
PADDLE_TRIS = np.array([[0, 1, 2], [0, 2, 3]], np.int32)


def spinning_paddle() -> MpmData:
    """sand_box_3d(nxz=8, ny=16) with its cuboid paddle replaced by a
    kinematic trimesh paddle (a 4 x 12 quad) at the paddle's pose, spinning
    at 2 rad/s about y, on the by = 8 pallas path."""
    d3 = scenes.sand_box_3d(nxz=8, ny=16, cell_width=1.0, with_paddle=False)
    paddle = RigidBodyDesc(Collider.trimesh(PADDLE_VERTS, PADDLE_TRIS), (0.0, 2.0, 0.0),
                           rotation=(0.0, 0.0, -0.5), body_type="kinematic",
                           angvel=(0.0, -2.0, 0.0))
    p = d3.state.particles
    return MpmData(d3.params, p.replace(pos=p.pos - jax.numpy.asarray([0.0, 3.0, 0.0])),
                   d3.state.models, list(d3.bodies_desc) + [paddle], 1.0,
                   grid=d3.config.grid, transfer="pallas", group=256, job_chunk=8,
                   by=8)


def blade_collider(cx, angle, half_len, height=6.0):
    """examples/elastic_cut3.py's blade: a vertical quad rotated about y."""
    v = np.array([[-half_len, 0, 0], [half_len, 0, 0], [half_len, height, 0],
                  [-half_len, height, 0]], np.float32)
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    v = v @ rot.T + np.array([cx, 2.0, 0.0], np.float32)
    return Collider.trimesh(v, np.array([[0, 1, 2], [0, 2, 3]], np.int32))


def blades(max_stretch: float = 1.0002) -> MpmData:
    """examples/elastic_cut3.py at its smallest size (10 x 6 x 10 elastic
    particles, cell 1, the floor and three blades), the block lowered onto
    the blades' tops (y = 8) and falling at 4 m/s so that lanes stretch
    past max_stretch and fracture; group 64, by 4."""
    nx, nyz, h = 10, 6, 1.0
    xs = (np.arange(nx) + 0.5) * h / 2 - nx * h / 4
    ys = (np.arange(nyz) + 0.5) * h / 2 + 7.0
    g = np.meshgrid(xs, ys, xs, indexing="ij")
    pos = np.stack([a.ravel() for a in g], -1).astype(np.float32)
    n = len(pos)
    vel = np.tile(np.array([[0.0, -4.0, 0.0]], np.float32), (n, 1))
    parts = Particles.from_arrays(pos, density=1000.0, radius=h / 4).replace(
        vel=jax.numpy.asarray(vel))
    e = ElasticCoefficients.from_young_modulus(1e7, 0.2)
    models = Models.from_arrays(n, e.lam, e.mu, phase=1.0, max_stretch=max_stretch)
    ext = nx * h
    bodies = [RigidBodyDesc(Collider.cuboid(ext * 3, 1.0, ext * 3), (0, -1.0, 0)),
              RigidBodyDesc(blade_collider(-ext / 4, 0.4, ext), (0.0, 0.0, 0.0)),
              RigidBodyDesc(blade_collider(0.0, -0.3, ext), (0.0, 0.0, 0.0)),
              RigidBodyDesc(blade_collider(ext / 4, 0.1, ext), (0.0, 0.0, 0.0))]
    params = SimulationParams.new(dt=(1 / 60) / 20, gravity=[0.0, -9.81 * 4.0, 0.0])
    return MpmData(params, parts, models, bodies, h,
                   grid_bounds=(np.array([-ext, -2.0, -ext]), np.array([ext, 25.0, ext])),
                   transfer="pallas", group=64, job_chunk=8)


def jax_pass(jd: MpmData):
    """The JAX package's mesh pass of jd's state as the port's (key, word)
    int32 words, block-major (ghost block dropped)."""
    cfg = jd.config
    b = jbody.update_world_mass_properties(jd.state.bodies)
    key, asg = jrc.mesh_node_cdf(jd.state.meshes, b, cfg.grid, cfg.mesh_cids,
                                 cfg.sample_group, cfg.sample_max_jobs,
                                 cfg.sample_chunk, by=cfg.by)
    key = np.asarray(key)[:-1].reshape(-1).view(np.int32)
    asg = np.asarray(asg)[:-1].reshape(-1, asg.shape[-1])
    word = np.zeros(key.shape, np.uint32)
    for i, s in enumerate(cfg.mesh_cids):
        word |= np.where(asg[:, 2 * i] > 0, np.uint32(1 << s), np.uint32(0))
        word |= np.where(asg[:, 2 * i + 1] > 0, np.uint32(1 << (s + 16)), np.uint32(0))
    return key, word.view(np.int32)


def port_pass(jd: MpmData):
    """The port's plain mesh pass of jd's state: (key, word) numpy int32.
    It takes the JAX package's world-space samples and vertices, so that
    the pass alone is compared (test_torch_mesh_colliders.py holds the
    world transform to 1e-6 apart)."""
    cfg = interop.config_from_reference(jd.config)
    b = jbody.update_world_mass_properties(jd.state.bodies)
    sw, vw = jrc.world_transform(jd.state.meshes, b)
    m = jd.state.meshes
    key, word = trc.mesh_node_cdf(*(torch.as_tensor(np.array(x)) for x in (
        sw, vw, m.sample_prim, m.sample_cid)), cfg.grid, cfg.by)
    return key.numpy(), word.numpy()


def edge_plane_nodes(jd: MpmData, rel: float = 1e-6):
    """[M] bool over the block-major nodes: the node lies on the plane of a
    triangle's edge (3D) or on the perpendicular through a segment's end
    (2D) to rel of the scene's scale, computed in float64.  There the
    inside test is an exact zero that XLA:CPU's multiply-adds may turn
    either way, so the two packages may differ on such a node."""
    from wgsparkl_tpu_torch.ops import blocked as bk

    cfg = interop.config_from_reference(jd.config)
    x = np.stack([p.numpy() for p in bk.block_major_node_positions_ch(
        cfg.grid, cfg.by, "cpu")], -1).astype(np.float64)
    sw, vw = jrc.world_transform(jd.state.meshes, jbody.update_world_mass_properties(
        jd.state.bodies))
    vw = np.asarray(vw, np.float64)
    near = np.zeros(len(x), bool)
    for p in np.unique(np.asarray(jd.state.meshes.sample_prim), axis=0):
        v = vw[p]
        if x.shape[1] == 2:
            ab = v[1] - v[0]
            t = (x - v[0]) @ ab / (ab @ ab)
            near |= (np.abs(t) < rel) | (np.abs(t - 1.0) < rel)
            continue
        n = np.cross(v[1] - v[0], v[2] - v[0])
        for a, b in ((0, 1), (1, 2), (0, 2)):
            e = np.cross(v[b] - v[a], n)
            ap = x - v[a]
            scale = np.linalg.norm(e) * (np.linalg.norm(ap, axis=1) + 1.0)
            near |= np.abs(ap @ e) <= rel * scale
    return near


def compare_passes(key, word, jkey, jword, edge=None):
    """Off the edge-plane nodes (edge: [M] bool, see edge_plane_nodes):
    finite nodes, collider ids and affinity words equal, distances within
    1e-6 x the largest world coordinate of the grid (8 ulps of it: the
    signed distance n.ap / |n| is a difference of products of coordinates,
    which XLA:CPU may contract to multiply-adds).  Returns the number of
    edge-plane nodes whose key or word differ."""
    off = np.ones(len(key), bool) if edge is None else ~edge
    fin = key < trc.INF_KEY
    np.testing.assert_array_equal(fin[off], (jkey < trc.INF_KEY)[off])
    both = fin & off
    np.testing.assert_array_equal(key[both] & 15, jkey[both] & 15)
    np.testing.assert_array_equal(word[off], jword[off])
    assert fin.sum() > 10 and (word != 0).sum() > 10
    return both, int(((key != jkey) | (word != jword))[~off].sum())


def grid_span(jd: MpmData) -> float:
    """max(1, the largest |world coordinate| of a grid node)."""
    g = jd.config.grid
    lo = np.asarray(g.origin_cell, np.float64) * g.cell_width
    hi = lo + (np.asarray(g.shape) - 1) * g.cell_width
    return max(1.0, float(np.abs(lo).max()), float(np.abs(hi).max()))


def check_pass(jd: MpmData):
    """The port's pass against the JAX package's on jd (compare_passes);
    returns (mesh nodes, differing edge-plane nodes)."""
    key, word = port_pass(jd)
    jkey, jword = jax_pass(jd)
    both, differ = compare_passes(key, word, jkey, jword, edge_plane_nodes(jd))
    np.testing.assert_allclose((key[both] & -16).view(np.float32),
                               (jkey[both] & -16).view(np.float32), rtol=0,
                               atol=1e-6 * grid_span(jd))
    return int((key < trc.INF_KEY).sum()), differ


def run_both(jd: MpmData, substeps: int):
    """(JAX state, port state) after `substeps` substeps from jd's state
    (one frame of each), the port built from the same configuration."""
    cfg = interop.config_from_reference(jd.config)
    params = interop.params_from_reference(jd.params, "cpu")
    return (_j_step(jd.state, jd.params, jd.config, substeps),
            step_pallas(interop.state_from_reference(jd.state, "cpu"), params, cfg,
                        substeps))


def _stencil_touches(jd: MpmData, pos, nodes):
    """[N] bool: the particle's 3^d stencil (base round(p / h) - 1) holds a
    node of `nodes` ([M] bool over the block-major nodes)."""
    from wgsparkl_tpu_torch.ops import blocked as bk

    g = interop.config_from_reference(jd.config).grid
    d, by = g.dim, jd.config.by
    bsh, nb = bk.block_shape(d, by), bk.num_blocks(g, by)
    st = bk.storage_strides(nb)
    base = (np.round(np.asarray(pos, np.float32) / np.float32(g.cell_width)).astype(
        np.int64) - 1 - np.asarray(g.origin_cell))
    hit = np.zeros(len(base), bool)
    for k in np.ndindex(*(3,) * d):
        c = base + np.asarray(k)
        ok = np.all((c >= 0) & (c < np.asarray(g.shape)), axis=1)
        c = np.where(ok[:, None], c, 0)
        blk = sum((c[:, a] // bsh[a]) * st[a] for a in range(d))
        inner = np.ravel_multi_index(tuple(c[:, a] % bsh[a] for a in range(d)), bsh)
        hit |= ok & nodes[blk * int(np.prod(bsh)) + inner]
    return hit


def run_each(jd: MpmData, substeps: int, each):
    """`substeps` single substeps, both packages started each time from the
    JAX state (a penetrating start amplifies f32 roundoff from substep to
    substep); each(ref, out, skip) is called on every pair, skip [N] the
    particles (by identity order) whose stencil holds a node on which the
    two packages' mesh passes differ (an edge-plane node, see
    edge_plane_nodes).  Returns the last pair and the most such
    particles in a substep."""
    cfg = interop.config_from_reference(jd.config)
    params = interop.params_from_reference(jd.params, "cpu")
    state, most = jd.state, 0
    for _ in range(substeps):
        now = types.SimpleNamespace(config=jd.config, state=state)
        key, word = port_pass(now)
        jkey, jword = jax_pass(now)
        fin, jfin = key < trc.INF_KEY, jkey < trc.INF_KEY
        far = np.abs((key & -16).view(np.float32) - (jkey & -16).view(np.float32))
        differ = ((fin != jfin) | (word != jword)
                  | (fin & jfin & (((key & 15) != (jkey & 15))
                                   | (far > 1e-6 * grid_span(jd)))))
        assert not (differ & ~edge_plane_nodes(now)).any()
        ij = np.argsort(np.asarray(state.particles.ids))
        skip = _stencil_touches(jd, np.asarray(state.particles.pos)[ij], differ)
        most = max(most, int(skip.sum()))
        ref = _j_step(state, jd.params, jd.config, 1)
        out = step_pallas(interop.state_from_reference(state, "cpu"), params, cfg, 1)
        each(ref, out, skip)
        state = ref
    return ref, out, most


def compare_slice(ref, out, skip=None, pos_tol=5e-5, vel_tol=1e-3):
    """test_mesh_colliders.py's path-vs-path tolerances: positions 5e-5,
    velocities 1e-3, affinity words exact, particles by identity; the
    scene must have touched a collider.  skip ([N] bool by identity):
    particles held to their affinity words only."""
    ij = np.argsort(np.asarray(ref.particles.ids))
    it = np.argsort(out.particles.ids.numpy())
    keep = slice(None) if skip is None else ~skip
    np.testing.assert_allclose(out.particles.pos.numpy()[it][keep],
                               np.asarray(ref.particles.pos)[ij][keep], rtol=0,
                               atol=pos_tol)
    np.testing.assert_allclose(out.particles.vel.numpy()[it][keep],
                               np.asarray(ref.particles.vel)[ij][keep], rtol=0,
                               atol=vel_tol)
    aff = np.asarray(ref.particles.cdf_affinity)[ij]
    np.testing.assert_array_equal(out.particles.cdf_affinity.numpy().view(np.uint32)[it],
                                  aff)
    assert (aff != 0).any()
    for f in ("pos", "rot"):
        np.testing.assert_allclose(getattr(out.bodies, f).numpy(),
                                   np.asarray(getattr(ref.bodies, f)), rtol=0, atol=1e-6)
    return ij, it
