"""The PyTorch port's dense transfer (`MpmData(transfer="dense")`) against the
JAX package: the particle CDF, P2G and G2P on the same inputs, made from a
seed with numpy (2D and 3D, with colliders); the dense substep against
JAX's `substep` on tests/test_step.py's elastic and sand scenes, on the
fracture scene and on a mesh scene; the same scenes against the numpy
oracle (tests/oracle_mpm.py) at tests/test_step.py's tolerances and the CPIC
scene against tests/oracle_cpic.py at test_vs_oracle_cpic's, with and
without its dynamic plate; and `interop.config_from_reference` on dense and
blocked configurations.

Port against JAX: affinity words exactly; floats to fp32 roundoff (the
packages sum P2G in other orders), the tolerances stated at each check."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle_cpic import Body, OracleCpic
from oracle_mpm import OracleSim
from test_cpic_oracle import _scene as cpic_scene
from test_mesh_colliders import _mesh_scene
from test_step import _block2d, _make_state
from torch_port_helpers import port_bodies

from wgsparkl_tpu.collision import cdf as jcdf
from wgsparkl_tpu.grid import GridConfig as JGrid
from wgsparkl_tpu.models import DruckerPrager as JDP
from wgsparkl_tpu.models import ElasticCoefficients as JEC
from wgsparkl_tpu.models.drucker_prager import drucker_prager_arrays as j_dp_arrays
from wgsparkl_tpu.ops import transfer as jtr
from wgsparkl_tpu.params import SimulationParams as JParams
from wgsparkl_tpu.pipeline import MpmConfig as JConfig
from wgsparkl_tpu.pipeline import _node_cdf_full, substep
from wgsparkl_tpu.rigid import body as jbody
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch.collision import cdf as tcdf
from wgsparkl_tpu_torch.collision.shapes import Collider
from wgsparkl_tpu_torch.grid import GridConfig
from wgsparkl_tpu_torch.models import ElasticCoefficients
from wgsparkl_tpu_torch.models.drucker_prager import DruckerPrager, drucker_prager_arrays
from wgsparkl_tpu_torch.ops import rows as R
from wgsparkl_tpu_torch.ops import rows2d as R2
from wgsparkl_tpu_torch.ops import transfer as ttr
from wgsparkl_tpu_torch.ops.update_rows import _rigid_velocity
from wgsparkl_tpu_torch.parallel import spatial_config
from wgsparkl_tpu_torch.params import SimulationParams
from wgsparkl_tpu_torch.pipeline import (MpmData, RigidBodyDesc, _body_table,
                                         pallas_npad, step)
from wgsparkl_tpu_torch.solver import Models, Particles, attach_material_table

_substep = jax.jit(substep, static_argnums=2)


def run_both(state, params, cfg, substeps):
    """(JAX state, port state) after `substeps` dense substeps from the same
    JAX state and configuration."""
    ref = state
    for _ in range(substeps):
        ref = _substep(ref, params, cfg)
    out = step(interop.state_from_reference(state, "cpu"),
               interop.params_from_reference(params, "cpu"),
               interop.config_from_reference(cfg), substeps)
    return ref, out


def assert_close(ref, out, pos, vel, f):
    """Particles in the same order: positions, velocities, F within the
    given tolerances, affinity words and phases exactly."""
    rp, op = ref.particles, out.particles
    np.testing.assert_allclose(op.pos.numpy(), np.asarray(rp.pos), rtol=0, atol=pos)
    np.testing.assert_allclose(op.vel.numpy(), np.asarray(rp.vel), rtol=0, atol=vel)
    np.testing.assert_allclose(op.def_grad.numpy(), np.asarray(rp.def_grad), rtol=0,
                               atol=f)
    np.testing.assert_array_equal(op.cdf_affinity.numpy().view(np.uint32),
                                  np.asarray(rp.cdf_affinity))
    np.testing.assert_array_equal(out.models.phase.numpy(), np.asarray(ref.models.phase))


# ---------------------------------------------------------------- test_step.py scenes
def _step_scene(kind):
    """tests/test_step.py's elastic (2D, 3D) and sand scenes: (JAX state,
    params, config, oracle, oracle tolerances)."""
    h = 0.1
    dim = 3 if kind == "elastic3" else 2
    if kind == "sand":
        pos = _block2d(h, n=6, jitter=0.02 * h, seed=3)
        vel = np.random.default_rng(4).uniform(-1.0, 1.0, pos.shape).astype(np.float32)
        m = JEC.from_young_modulus(1e6, 0.2)
        dp = j_dp_arrays([JDP.new(1e6, 0.2)] * len(pos))
        state = _make_state(pos, vel, m.lam, m.mu, h, dp=dp)
        extra = dict(dp={k: np.asarray(v) for k, v in dp.items()})
        tol = (5e-5, 5e-4, 1e-3)
    else:
        rng = np.random.default_rng(1)
        if dim == 2:
            pos = _block2d(h, n=6, jitter=h * 0.1)
        else:
            xs = np.arange(4) * h / 2 + h / 4
            g = np.meshgrid(xs + 0.3, xs + 0.5, xs + 0.3, indexing="ij")
            pos = np.stack([a.ravel() for a in g], -1).astype(np.float32)
            pos += rng.uniform(-h * 0.1, h * 0.1, pos.shape).astype(np.float32)
        vel = rng.uniform(-0.5, 0.5, pos.shape).astype(np.float32)
        m = JEC.from_young_modulus(1e5, 0.3)
        state = _make_state(pos, vel, m.lam, m.mu, h, phase=1.0)
        extra = dict(phase=np.ones(len(pos)))
        tol = (2e-5, 2e-4, 2e-4)
    cfg = JConfig(grid=JGrid(shape=(32,) * dim, cell_width=h, origin_cell=(-8,) * dim))
    params = JParams.new(dt=1e-3, gravity=[0.0, -9.81] + [0.0] * (dim - 2))
    n = len(pos)
    oracle = OracleSim(pos, vel, np.full(n, float(np.asarray(state.particles.mass)[0])),
                       np.full(n, float(np.asarray(state.particles.init_volume)[0])),
                       np.full(n, m.lam), np.full(n, m.mu), h, origin=(-8,) * dim,
                       shape=(32,) * dim, **extra)
    return state, params, cfg, oracle, tol


@pytest.mark.parametrize("kind", ["elastic2", "elastic3", "sand"])
def test_dense_substep_matches_jax_and_oracle(kind):
    """Ten substeps: the port within 2e-6 (pos), 1e-5 (vel, F) of JAX (fp32
    roundoff of another summation order; measured <= 4e-7), and within the
    numpy oracle's tolerances of tests/test_step.py, as JAX is."""
    state, params, cfg, oracle, (tp, tv, tf) = _step_scene(kind)
    ref, out = run_both(state, params, cfg, 10)
    assert_close(ref, out, 2e-6, 1e-5, 1e-5)
    for _ in range(10):
        oracle.step(1e-3, np.asarray(params.gravity))
    np.testing.assert_allclose(out.particles.pos.numpy(), oracle.p, atol=tp)
    np.testing.assert_allclose(out.particles.vel.numpy(), oracle.v, atol=tv)
    np.testing.assert_allclose(out.particles.def_grad.numpy(), oracle.F, atol=tf)
    if kind == "sand":
        assert (out.models.dp_state["hardening"].numpy() > 1.0).any()


def test_dense_fracture_matches_jax():
    """Kernel C's fracture check on the dense path against JAX's struct
    particle update (another SVD): tests/test_step.py's fracture scene with
    the lanes' stretches spread across max_stretch 1.2 (1.5, and 1.2 +-
    1e-3 .. 1e-2): the same phases after 3 substeps, F within 1e-5."""
    h = 0.1
    pos = _block2d(h, n=8)
    n = len(pos)
    m = JEC.from_young_modulus(1e5, 0.3)
    state = _make_state(pos, np.zeros_like(pos), m.lam, m.mu, h, phase=1.0,
                        max_stretch=1.2)
    f = np.tile(np.eye(2, dtype=np.float32), (n, 1, 1))
    f[: n // 4, 0, 0] = 1.5
    f[n // 4:, 0, 0] = 1.2 + np.linspace(-1e-2, 1e-2, n - n // 4).astype(np.float32)
    f[n // 4:, 0, 0] += np.where(np.abs(f[n // 4:, 0, 0] - 1.2) < 1e-3, 2e-3, 0.0)
    state = state.replace(particles=state.particles.replace(def_grad=jnp.asarray(f)))
    cfg = JConfig(grid=JGrid(shape=(32, 32), cell_width=h, origin_cell=(-8, -8)))
    params = JParams.new(dt=1e-3, gravity=[0.0, 0.0])
    ref, out = run_both(state, params, cfg, 3)
    assert_close(ref, out, 1e-6, 1e-5, 1e-5)
    phase = out.models.phase.numpy()
    assert (phase == 0.0).sum() > n // 4 and (phase == 1.0).any()


def _polyline_scene():
    """tests/test_mesh_colliders.py's 2D scene (test_mesh_collider_paths_
    agree_2d): an elastic 10 x 10 block above a two-segment polyline tent
    and a cuboid floor, on the dense transfer."""
    from wgsparkl_tpu.collision.shapes import Collider as JCollider
    from wgsparkl_tpu.pipeline import MpmData as JMpmData
    from wgsparkl_tpu.pipeline import RigidBodyDesc as JDesc
    from wgsparkl_tpu.solver import Models as JModels
    from wgsparkl_tpu.solver import Particles as JParticles

    h = 0.5
    poly = JCollider.polyline(np.array([[-4.0, 0.0], [0.0, 1.0], [4.0, 0.0]], np.float32),
                              np.array([[0, 1], [1, 2]], np.int32))
    xs = np.arange(10) * h / 2 + h / 4
    g = np.meshgrid(xs - 1.25, xs + 1.2, indexing="ij")
    pos = np.stack([a.ravel() for a in g], -1).astype(np.float32)
    m = JEC.from_young_modulus(1e6, 0.2)
    return JMpmData(JParams.new(dt=1 / 600, gravity=[0, -9.81]),
                    JParticles.from_arrays(pos, density=1000.0, radius=h / 4),
                    JModels.from_arrays(len(pos), m.lam, m.mu, phase=1.0),
                    [JDesc(poly, (0.0, 0.0)), JDesc(JCollider.cuboid(6.0, 0.5), (0.0, -1.2))],
                    cell_width=h, grid_bounds=(np.array([-4.0, -2.0]), np.array([4.0, 6.0])))


@pytest.mark.parametrize("scene", ["ramp_3d", "polyline_2d"])
def test_dense_mesh_scene_matches_jax(scene):
    """tests/test_mesh_colliders.py's trimesh ramp and cuboid floor (3D) and
    polyline tent and cuboid floor (2D) on the dense path, 12 substeps:
    JAX's tolerances of test_mesh_colliders (pos 5e-5, vel 1e-3; measured
    ~1e-6), affinity words exactly, and the block touched the mesh."""
    jd = _mesh_scene("dense") if scene == "ramp_3d" else _polyline_scene()
    ref, out = run_both(jd.state, jd.params, jd.config, 12)
    assert_close(ref, out, 5e-5, 1e-3, 1e-3)
    aff = np.asarray(ref.particles.cdf_affinity)
    assert (aff & 1).any()


def test_dense_dynamic_bodies_contacts_and_joints_match_jax():
    """Dynamic bodies on the dense path: the small sand box lattice (no
    paddle) lowered onto a dynamic plate sunk 2 slops into the floor (body
    contacts on), its top held by a ball joint to a fixed ball (chip_smoke
    .plate_joint_3d's scene), 5 substeps, each started in both packages
    from JAX's state (the penetrating start amplifies roundoff from substep
    to substep): tests/test_torch_dynamic_slice.py's tolerances (positions
    1e-5, velocities and F 1e-4, affinity words exact, bodies 1e-5 x
    max(1, |reference|))."""
    from wgsparkl_tpu import scenes as jscenes
    from wgsparkl_tpu.collision.shapes import Collider as JCollider
    from wgsparkl_tpu.pipeline import MpmData as JMpmData
    from wgsparkl_tpu.pipeline import RigidBodyDesc as JDesc

    d3 = jscenes.sand_box_3d(nxz=8, ny=16, cell_width=1.0, with_paddle=False)
    p = d3.state.particles
    p = p.replace(pos=p.pos + np.asarray([0.0, -4.0, 0.0], np.float32))
    bodies = list(d3.bodies_desc) + [
        JDesc(JCollider.cuboid(1.2, 0.6, 1.2), (0.3, 0.5, -0.2), rotation=(0.0, 0.3, 0.0),
              body_type="dynamic", density=2000.0),
        JDesc(JCollider.ball(0.3), (0.3, 3.0, -0.2))]
    jd = JMpmData(d3.params, p, d3.state.models, bodies, 1.0, grid=d3.config.grid,
                  joints=((5, 6, (0.0, 0.6, 0.0), (0.0, -1.9, 0.0)),))
    cfg = interop.config_from_reference(jd.config)
    assert cfg.transfer == "dense" and cfg.dynamic_slots == (5,) and cfg.joints
    params = interop.params_from_reference(jd.params, "cpu")
    state = jd.state
    for _ in range(5):
        ref = _substep(state, jd.params, jd.config)
        out = step(interop.state_from_reference(state, "cpu"), params, cfg, 1)
        assert_close(ref, out, 1e-5, 1e-4, 1e-4)
        for f in ("pos", "rot", "linvel", "angvel"):
            r = np.asarray(getattr(ref.bodies, f))
            e = float(np.abs(getattr(out.bodies, f).numpy() - r).max())
            assert e <= 1e-5 * max(1.0, float(np.abs(r).max())), (f, e)
        state = ref
    assert float(np.abs(np.asarray(ref.bodies.linvel)[5]).max()) > 0.0
    assert (np.asarray(ref.particles.cdf_affinity) & (1 << 5)).any()


# ---------------------------------------------------------------- the kernels' functions
def _transfer_inputs(dim):
    """A JAX dense scene with colliders and the inputs of one substep's
    particle CDF and transfers, velocities, affine matrices and previous
    affinity words random from numpy seed 7: 3D the CPIC oracle scene
    (a static floor, a kinematic wall, a dynamic plate), 2D a lattice on a
    static floor beside a spinning kinematic ball, lowered 0.2 into the
    floor."""
    from wgsparkl_tpu.collision.shapes import Collider as JCollider
    from wgsparkl_tpu.pipeline import MpmData as JMpmData
    from wgsparkl_tpu.pipeline import RigidBodyDesc as JDesc
    from wgsparkl_tpu.solver import Models as JModels
    from wgsparkl_tpu.solver import Particles as JParticles

    rng = np.random.default_rng(7)
    if dim == 3:
        jd = cpic_scene()[0]
    else:
        pos = _block2d(0.25, n=16, offset=(-2.0, -0.2), jitter=0.02)
        m = JEC.from_young_modulus(1e5, 0.3)
        jd = JMpmData(JParams.new(dt=1e-3, gravity=[0.0, -9.81]),
                      JParticles.from_arrays(pos, density=1000.0, radius=0.25 / 4),
                      JModels.from_arrays(len(pos), m.lam, m.mu, phase=1.0),
                      [JDesc(JCollider.cuboid(6.0, 0.5), (0.0, -0.5)),
                       JDesc(JCollider.ball(0.6), (0.4, 0.5), body_type="kinematic",
                             linvel=(0.3, 0.0), angvel=1.5)],
                      0.25, grid_bounds=(np.array([-4.0, -2.0]), np.array([4.0, 4.0])))
    st = jd.state
    n = st.particles.count
    p = st.particles.replace(
        vel=jnp.asarray(rng.uniform(-1, 1, (n, dim)).astype(np.float32)),
        affine=jnp.asarray(rng.uniform(-5, 5, (n, dim, dim)).astype(np.float32)),
        cdf_affinity=jnp.asarray(rng.integers(0, 4, n).astype(np.uint32)
                                 * np.uint32(0x10001) & np.uint32(0x30003)))
    return jd, p, jbody.update_world_mass_properties(st.bodies)


@pytest.mark.parametrize("dim", [2, 3])
def test_particle_cdf_and_transfers_match_jax(dim):
    """particle_cdf_update, P2G (grid and CPIC impulses), G2P and the rigid
    contact velocity of the port's plain versions and of the wrappers on
    the row matrix against the JAX package's functions on the same inputs:
    affinity words exactly;
    normals and distances within 1e-4 (the explicit inverse of the normal
    equations amplifies fp32 roundoff: up to 1.4e-5 seen), G2P and the
    rigid velocity within 1e-5, the grid within 1e-5 of its largest value,
    impulses within 1e-5 of theirs (fp32 roundoff of other summation
    orders)."""
    jd, jp, jb = _transfer_inputs(dim)
    cfg, grid = jd.config, interop.config_from_reference(jd.config).grid
    nc = cfg.num_colliders
    node_dist, node_aff, node_closest = _node_cdf_full(jd.state, jb, cfg)
    ref = jcdf.particle_cdf_update(jp.pos, jp.cdf_affinity, node_dist, node_aff,
                                   cfg.grid, nc)
    t = lambda x: torch.as_tensor(np.array(np.asarray(x).view(np.int32)  # noqa: E731
                                           if np.asarray(x).dtype == np.uint32
                                           else np.asarray(x)))
    tdist, taff, tclosest = t(node_dist), t(node_aff), t(node_closest)
    out = tcdf.particle_cdf_update(t(jp.pos), t(jp.cdf_affinity), tdist, taff, grid, nc)
    np.testing.assert_array_equal(out["affinity"].numpy().view(np.uint32),
                                  np.asarray(ref["affinity"]))
    assert (np.asarray(ref["affinity"]) >> 16 != 0).any()
    np.testing.assert_allclose(out["normal"].numpy(), np.asarray(ref["normal"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["signed_distance"].numpy(),
                               np.asarray(ref["signed_distance"]), rtol=0, atol=1e-4)

    jp0, jp = jp, jp.replace(cdf_normal=ref["normal"],
                             cdf_signed_distance=ref["signed_distance"],
                             cdf_affinity=ref["affinity"])
    gm, gmass, lin, ang = jtr.p2g(jp, jd.state.models, jb, node_aff, node_closest,
                                  cfg.grid, nc)
    params = jd.params
    gvel = jtr.grid_update(gm, gmass, params, cfg.grid)
    v, grad, rv = jtr.g2p(jp, jb, gvel, node_aff, node_closest, cfg.grid, nc)

    st = interop.state_from_reference(jd.state.replace(particles=jp0, bodies=jb), "cpu")
    models, _ = attach_material_table(st.particles, st.models)
    n = st.particles.count
    L = R if dim == 3 else R2
    rows = L.pack_rows_padded(st.particles, models, pallas_npad(n, 256))
    pcdf = tcdf.dense_pcdf(rows, n, tdist, taff, grid, nc)
    assert torch.equal(R.aff_from_halves(pcdf[0, :n], pcdf[2 + dim, :n]), out["affinity"])
    tparams = interop.params_from_reference(params, "cpu")
    btable = _body_table(st.bodies, tparams, grid)
    mm, tlin, tang = ttr.dense_p2g(rows, pcdf, n, None, taff, tclosest, btable, grid,
                                   nc, st.bodies.count)
    jmm = np.concatenate([np.asarray(gm), np.asarray(gmass)[:, None]], 1)
    np.testing.assert_allclose(mm.numpy(), jmm, rtol=0, atol=1e-5 * np.abs(jmm).max())
    for a, b in ((tlin, lin), (tang, ang)):
        b = np.asarray(b)
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max())
    tvel = ttr.grid_update(mm, tparams, grid)
    krows = ttr.dense_g2p(rows, pcdf, n, None, tvel, taff, tclosest, btable, grid, nc)
    np.testing.assert_allclose(krows[:dim, :n].T.numpy(), np.asarray(v), rtol=0,
                               atol=1e-5)
    tgrad = (krows[dim:dim + dim * dim, :n].T * (4.0 / grid.cell_width ** 2)).reshape(
        n, dim, dim)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(grad), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(grad)).max())
    # The rigid contact velocity: rigid_velocity_sum and kernel C's plain
    # version of it (which the step runs) against JAX's.
    tpos = st.particles.pos
    trv = ttr.rigid_velocity_sum(tpos, out["affinity"], btable, nc)
    crv = torch.stack(_rigid_velocity([tpos[:, a] for a in range(dim)],
                                      out["affinity"], btable, nc), -1)
    assert np.abs(np.asarray(rv)).max() > 0
    for x in (trv, crv):
        np.testing.assert_allclose(x.numpy(), np.asarray(rv), rtol=0, atol=1e-5)


# ---------------------------------------------------------------- the CPIC oracle
@pytest.mark.parametrize("plate", [False, True])
def test_dense_matches_cpic_oracle(plate):
    """tests/test_cpic_oracle.py's scene on the port's dense path, built with
    the port's MpmData, 12 substeps against the numpy CPIC oracle at
    test_vs_oracle_cpic's tolerances (pos 5e-5, vel 1e-3, F 5e-4, distance
    5e-4, affinity words exactly; the plate's pose 1e-5, velocities 1e-4;
    the kinematic wall 1e-6), without and with the dynamic plate."""
    rng = np.random.default_rng(3)
    cw = 0.5
    xs = np.arange(8) * 0.25 - 1.0
    ys = np.arange(5) * 0.25 + 0.15
    zs = np.arange(6) * 0.25 - 0.7
    pos = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)
    pos = (pos + rng.uniform(-0.02, 0.02, pos.shape)).astype(np.float32)
    n = len(pos)
    phase = (pos[:, 0] > 0.0).astype(np.float32)
    elast = ElasticCoefficients.from_young_modulus(5.0e5, 0.2)
    dpm = drucker_prager_arrays([DruckerPrager.new(5.0e5, 0.2)])
    dp = {k: np.full(n, v[0]) for k, v in dpm.items()}
    bodies = [RigidBodyDesc(Collider.cuboid(4.0, 0.5, 4.0), (0.0, -0.5, 0.0)),
              RigidBodyDesc(Collider.cuboid(0.25, 1.5, 2.0), (-1.6, 1.0, 0.0),
                            body_type="kinematic", linvel=(0.4, 0.0, 0.0))]
    obodies = [Body((4.0, 0.5, 4.0), (0.0, -0.5, 0.0)),
               Body((0.25, 1.5, 2.0), (-1.6, 1.0, 0.0), linvel=(0.4, 0.0, 0.0))]
    if plate:
        bodies.append(RigidBodyDesc(Collider.cuboid(0.5, 0.25, 0.5), (0.4, 1.72, -0.2),
                                    body_type="dynamic", density=400.0))
        obodies.append(Body((0.5, 0.25, 0.5), (0.4, 1.72, -0.2), density=400.0))
    data = MpmData(SimulationParams.new(1e-3, [0.0, -9.81, 0.0], device="cpu"),
                   Particles.from_arrays(pos, density=1200.0, radius=cw / 4, device="cpu"),
                   Models.from_arrays(n, elast.lam, elast.mu, dp=dp, phase=phase,
                                      device="cpu"),
                   bodies, cw, grid=GridConfig.from_bounds(
                       np.array([-4.0, -2.0, -4.0]), np.array([4.0, 4.0, 4.0]), cw),
                   transfer="dense", body_contacts=False)
    assert data.config.transfer == "dense" and not data.config.chan_free
    p, m, g = data.state.particles, data.state.models, data.config.grid
    oracle = OracleCpic(p.pos.numpy(), p.vel.numpy(), p.mass.numpy(),
                        p.init_volume.numpy(), m.lam.numpy(), m.mu.numpy(),
                        g.cell_width, g.origin_cell, g.shape, dp=dp, phase=phase,
                        bodies=obodies)
    state = data.state
    for _ in range(12):
        state = step(state, data.params, data.config, 1)
        oracle.step(1e-3, data.params.gravity.numpy())
    sp, b = state.particles, state.bodies
    np.testing.assert_array_equal(sp.ids.numpy(), np.arange(n))
    np.testing.assert_allclose(sp.pos.numpy(), oracle.p, atol=5e-5)
    np.testing.assert_allclose(sp.vel.numpy(), oracle.v, atol=1e-3)
    np.testing.assert_allclose(sp.def_grad.numpy(), oracle.F, atol=5e-4)
    np.testing.assert_array_equal(sp.cdf_affinity.numpy().view(np.uint32),
                                  oracle.aff.astype(np.uint32))
    np.testing.assert_allclose(sp.cdf_signed_distance.numpy(), oracle.sd, atol=5e-4)
    np.testing.assert_allclose(b.pos.numpy()[1], obodies[1].pos, atol=1e-6)
    aff = oracle.aff.astype(np.uint32)
    assert (aff & 1).any() and (aff & 2).any()
    if plate:
        np.testing.assert_allclose(b.pos.numpy()[2], obodies[2].pos, atol=1e-5)
        np.testing.assert_allclose(b.linvel.numpy()[2], obodies[2].linvel, atol=1e-4)
        np.testing.assert_allclose(b.angvel.numpy()[2], obodies[2].angvel, atol=1e-4)
        assert np.linalg.norm(obodies[2].linvel) > 1e-6


# ---------------------------------------------------------------- interop
@pytest.mark.parametrize("transfer", ["dense", "blocked"])
def test_config_from_reference_dense_and_blocked(transfer):
    """config_from_reference carries transfer and job_chunk, and the port's
    MpmData sizes the job table as the JAX package does (4 ceil(N / group)
    + 64, rounded to job_chunk and 64; none for dense); the multi-device
    fields come over too, and spatial slabs take the pallas transfer only,
    as in the JAX package."""
    jd = cpic_scene()[0]
    from wgsparkl_tpu.pipeline import MpmData as JMpmData

    kw = dict(transfer=transfer, group=64, job_chunk=8, body_contacts=False)
    jd = JMpmData(jd.params, jd.state.particles, jd.state.models, jd.bodies_desc,
                  jd.config.grid.cell_width, grid=jd.config.grid, **kw)
    cfg = interop.config_from_reference(jd.config)
    assert (cfg.transfer, cfg.job_chunk, cfg.group) == (transfer, 8, 64)
    st = interop.state_from_reference(jd.state, "cpu")
    td = MpmData(interop.params_from_reference(jd.params, "cpu"), st.particles,
                 st.models, port_bodies(jd.bodies_desc), cfg.grid.cell_width,
                 grid=cfg.grid, **kw)
    assert td.config.max_jobs == cfg.max_jobs == (128 if transfer == "blocked" else 0)
    assert dataclasses.replace(td.config, n_materials=1) == cfg
    sp = interop.config_from_reference(dataclasses.replace(jd.config, spatial_devices=2))
    assert sp.spatial_devices == 2 and dataclasses.replace(sp, spatial_devices=0) == cfg
    with pytest.raises(ValueError, match="pallas"):
        spatial_config(cfg, 2)
