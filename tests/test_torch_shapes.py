"""The port's analytic collider shapes (cuboid, ball, capsule, halfspace)
against the JAX package on seeded numpy inputs: the channel node CDF and
its merge of disjoint collider subsets in 2D and 3D (points at a ball's
centre, on a capsule's axis and on a halfspace's plane included), the
moving-collider reach gate per shape, the construction-time CDF-mode
choice on the JAX package's scenes, and the 16-collider scene stepped
against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from wgsparkl_tpu import scenes as jscenes
from wgsparkl_tpu.collision import cdf_channel as jcch
from wgsparkl_tpu.pipeline import MpmData as JMpmData
from wgsparkl_tpu.pipeline import RigidBodyDesc as JDesc
from wgsparkl_tpu.pipeline import _moving_reach_gate as j_gate
from wgsparkl_tpu.pipeline import build_rigid_world as j_world
from wgsparkl_tpu.pipeline import step_pallas as j_step
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch.collision import cdf_channel as cch
from wgsparkl_tpu_torch.collision import shapes as shp
from wgsparkl_tpu_torch.pipeline import _moving_reach_gate, step_pallas
from wgsparkl_tpu_torch.rigid.body import RigidWorld

torch.set_num_threads(2)

SHAPES = {"cuboid": shp.SHAPE_CUBOID, "ball": shp.SHAPE_BALL,
          "capsule": shp.SHAPE_CAPSULE, "halfspace": shp.SHAPE_HALFSPACE}


def _world(dim, seed=0):
    """Eight bodies: each shape twice, posed at random, then once more
    unrotated (ball, capsule, halfspace at slots 4-6) so that points on a
    ball's centre, a capsule's axis and a halfspace's plane are exact in
    local coordinates; a ball last at slot 7."""
    from wgsparkl_tpu.collision.shapes import Collider

    rng = np.random.default_rng(seed)
    made = [Collider.cuboid(*rng.uniform(0.4, 1.6, dim)), Collider.ball(1.3),
            Collider.capsule(1.5, 0.6), Collider.halfspace(),
            Collider.ball(0.9), Collider.capsule(0.8, 0.5), Collider.halfspace(),
            Collider.ball(0.7)]
    descs = []
    for i, c in enumerate(made):
        t = tuple(rng.uniform(-2.0, 2.0, dim).astype(np.float32).tolist())
        if dim == 2:
            rot = None if i in (4, 5, 6) else float(rng.uniform(-3, 3))
        else:
            rot = None if i in (4, 5, 6) else tuple(rng.normal(size=3).tolist())
        descs.append(JDesc(c, t, rotation=rot))
    return descs, j_world(descs, dim)


def _points(dim, descs, n=20000, seed=1):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4.5, 4.5, (n, dim)).astype(np.float32)
    k = 0
    for d in descs:                                    # every body's origin
        pts[k] = d.translation
        k += 1
    t5 = np.asarray(descs[5].translation, np.float32)  # on the capsule's axis
    for s in (-0.5, -0.25, 0.0, 0.25, 0.5):
        pts[k] = t5 + np.float32(s) * np.eye(dim, dtype=np.float32)[1]
        k += 1
    t6 = np.asarray(descs[6].translation, np.float32)  # on the halfspace's plane
    for _ in range(200):
        p = rng.uniform(-3.0, 3.0, dim).astype(np.float32)
        p[1] = t6[1]
        pts[k] = p
        k += 1
    return pts


def _port_world(jw):
    return RigidWorld(**{f: interop._t(getattr(jw, f), "cpu") for f in (
        "rot", "pos", "linvel", "angvel", "local_com", "world_com", "inv_mass",
        "inv_inertia_local", "inv_inertia_world", "shape_params")})


def _both_cdf(dim, only=None):
    descs, jw = _world(dim)
    types = tuple(d.collider.shape_type for d in descs)
    pts = _points(dim, descs)
    ref = jcch.node_cdf_channels(types, jw.shape_params, jw.rot, jw.pos,
                                 [jnp.asarray(pts[:, a]) for a in range(dim)], 0.5,
                                 only=only)
    tw = _port_world(jw)
    out = cch.node_cdf_channels(types, tw.shape_params, tw.rot, tw.pos,
                                [torch.as_tensor(pts[:, a]) for a in range(dim)], 0.5,
                                only=only)
    return [np.asarray(r) for r in ref], [o.numpy() for o in out], descs


@pytest.mark.parametrize("dim", [2, 3])
def test_node_cdf_channels_every_shape_match_jax(dim):
    (dj, aj, cj), (dt_, at, ct), descs = _both_cdf(dim)
    np.testing.assert_array_equal(at.view(np.uint32), aj)
    np.testing.assert_array_equal(ct, cj)
    # XLA:CPU contracts the rotations' multiply-adds, PyTorch rounds each
    # operation: distances (at most the 0.75 reach, BIG elsewhere) within
    # f32 roundoff of the local coordinates.
    np.testing.assert_allclose(dt_, dj, rtol=1e-6, atol=2e-6)
    # Every body's origin and the capsule's axis points: bit for bit.
    k = len(descs)
    np.testing.assert_array_equal(dt_[:k + 5], dj[:k + 5])
    # Each special point against its own collider alone: a ball's centre
    # projects along +x at the radius, a capsule's axis along +x at the
    # radius, a point on the halfspace's plane is on the boundary.
    (jd4, _, _), (d4, a4, c4), _ = _both_cdf(dim, frozenset([4]))
    assert c4[4] == 4 and d4[4] == np.float32(0.9) == jd4[4]
    assert a4[4] == (1 << 4) | (1 << 20)                  # inside
    (jd5, _, _), (d5, _, c5), _ = _both_cdf(dim, frozenset([5]))
    assert (c5[k:k + 5] == 5).all()
    np.testing.assert_array_equal(d5[k:k + 5], np.float32(0.5))
    np.testing.assert_array_equal(jd5[k:k + 5], np.float32(0.5))
    (jd6, _, _), (d6, a6, c6), _ = _both_cdf(dim, frozenset([6]))
    on_plane = slice(k + 5, k + 205)
    assert (c6[on_plane] == 6).all() and not d6[on_plane].any()
    np.testing.assert_array_equal(a6[on_plane].view(np.uint32), 1 << 6)  # not inside
    np.testing.assert_array_equal(jd6[on_plane], 0.0)
    for i in range(len(descs)):                           # every shape reached
        assert ((aj >> i) & 1).any() and ((aj >> (16 + i)) & 1).any()


@pytest.mark.parametrize("dim", [2, 3])
def test_merge_node_cdf_matches_jax_and_the_full_loop(dim):
    """Partials over two disjoint collider subsets merge to the triple of
    the full index-ordered loop, bit for bit, as in the JAX package."""
    first = frozenset((0, 3, 4, 7))
    rest = frozenset(range(8)) - first
    ja, ta, _ = _both_cdf(dim, first)
    jb, tb, _ = _both_cdf(dim, rest)
    _, full, _ = _both_cdf(dim)
    jm = jcch.merge_node_cdf(tuple(jnp.asarray(x) for x in ja),
                             tuple(jnp.asarray(x) for x in jb))
    tm = cch.merge_node_cdf(tuple(torch.as_tensor(x) for x in ta),
                            tuple(torch.as_tensor(x) for x in tb))
    for a, b in zip(tm, full):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(tm[1].numpy().view(np.uint32), np.asarray(jm[1]))
    np.testing.assert_array_equal(tm[2].numpy(), np.asarray(jm[2]))
    np.testing.assert_allclose(tm[0].numpy(), np.asarray(jm[0]), rtol=1e-6, atol=2e-6)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_moving_reach_gate_matches_jax(shape, dim):
    descs, jw = _world(dim)
    # The shape's rotated collider (slots 0-3).
    slot = [d.collider.shape_type for d in descs].index(SHAPES[shape])
    desc = ((slot, SHAPES[shape]),)
    rng = np.random.default_rng(3)
    bcells = rng.integers(-12, 8, (4000, dim)).astype(np.int32)
    wsh = (6, 10, 6) if dim == 3 else (10, 10)
    ref = np.asarray(j_gate(jnp.asarray(bcells), jw, desc, wsh, 0.5))
    out = _moving_reach_gate(torch.as_tensor(bcells), _port_world(jw), desc, wsh, 0.5)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert 0.02 < ref.mean() < 0.98


def _ball_scene(center, **kw):
    """tests/test_pallas_transfer.py:306-333: an 8^3 lattice high above a
    ball (JAX package)."""
    from wgsparkl_tpu.collision.shapes import Collider
    from wgsparkl_tpu.params import SimulationParams
    from wgsparkl_tpu.solver import Models, Particles

    pos = jscenes._lattice((8, 8, 8), 1.0, (20.0, 40.0, 20.0))
    n = len(pos)
    return JMpmData(
        SimulationParams.new(dt=1 / 1200, gravity=[0.0, -9.81, 0.0]),
        Particles.from_arrays(pos, density=1000.0, radius=0.25),
        Models.from_arrays(n, np.full(n, 1e5, np.float32), np.full(n, 1e5, np.float32)),
        [JDesc(Collider.ball(1.5), center)], 1.0,
        grid_bounds=(np.array([0.0, 0.0, 0.0]), np.array([48.0, 56.0, 48.0])),
        transfer="pallas", group=256, job_chunk=8, **kw)


def _sand_box():
    d3 = jscenes.sand_box_3d(nxz=8, ny=16, cell_width=1.0)
    return JMpmData(d3.params, d3.state.particles, d3.state.models, d3.bodies_desc,
                    1.0, grid=d3.config.grid, transfer="pallas", group=256,
                    job_chunk=8)


_MODE_SCENES = {
    # The flagship shape: matter settles onto the floor -> gathered.
    "sand_box": (_sand_box, False),
    # A ball clear of the falling column -> chan-free.
    "ball_aside": (lambda: _ball_scene((40.0, 30.0, 40.0)), True),
    # The same ball under the column catches it -> gathered.
    "ball_under": (lambda: _ball_scene((24.0, 30.0, 24.0)), False),
    # Path 5's bodies: the halfspace catches the falling sand -> gathered.
    "analytic_shapes": (lambda: H.jax_scene_shapes(chan_free=None), False),
}


@pytest.mark.parametrize("scene", sorted(_MODE_SCENES))
def test_auto_chan_free_matches_jax(scene, monkeypatch):
    """The construction-time CDF-mode heuristic picks the JAX package's
    mode on the scenes of tests/test_pallas_transfer.py:286-333 and on the
    analytic-shapes scene; the port's whole configuration equals the
    reference's."""
    monkeypatch.delenv("WGSPARKL_CHAN_FREE", raising=False)
    make, want = _MODE_SCENES[scene]
    jd = make()
    assert jd.config.chan_free is want
    td = H.port_data(jd, chan_free=None)
    assert td.config.chan_free is want
    assert td.config == interop.config_from_reference(jd.config)


_j_step = jax.jit(j_step, static_argnums=(2, 3))


def test_sixteen_colliders_match_jax():
    """15 static balls and a floor cuboid (affinity bits 15 and 31), three
    substeps against the JAX package, each from the JAX state."""
    data = H.jax_scene_16()
    params = interop.params_from_reference(data.params, "cpu")
    cfg = interop.config_from_reference(data.config)
    assert cfg == H.port_data(data, chan_free=None).config
    assert not cfg.chan_free and len(cfg.static_slots) == 16
    state = data.state
    for _ in range(3):
        ref = _j_step(state, data.params, data.config, 1)
        out = step_pallas(interop.state_from_reference(state, "cpu"), params, cfg, 1)
        H.compare_states(ref, out)
        state = ref
    aff = np.asarray(state.particles.cdf_affinity)
    assert (aff & np.uint32(1 << 15)).any()
    assert bin(int(np.bitwise_or.reduce(aff) & 0x7FFF)).count("1") >= 3
