"""The port's struct-form functions and helpers against the JAX package's of
the same names, on the same inputs made from numpy seeds: the dense
transfer's `p2g` / `g2p`, `particle_update` (3D and 2D, corotated and
neo-Hookean, and with fracture) and `particle_update_channels_2d`,
`node_cdf`, the blocked transfer's `p2g_blocked` / `g2p_blocked`, the
matrix SVD, the pose, body, grid and kernel helpers, the mesh utilities,
and the block geometry.

Floats agree to fp32 roundoff (other summation orders, another SVD), at the
tolerances stated at each check; integers (affinity words, block ids and
coordinates, permutations, window offsets, layouts) exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_blocked import _scene_3d
from test_torch_dense_transfer import _transfer_inputs

from wgsparkl_tpu import math as jmath
from wgsparkl_tpu.collision import cdf as jcdf
from wgsparkl_tpu.collision import shapes as jshapes
from wgsparkl_tpu.grid import GridConfig as JGrid
from wgsparkl_tpu.math import pose as jpose
from wgsparkl_tpu.models import DruckerPrager as JDP
from wgsparkl_tpu.models import ElasticCoefficients as JEC
from wgsparkl_tpu.models.drucker_prager import drucker_prager_arrays as j_dp_arrays
from wgsparkl_tpu.ops import blocked as jbk
from wgsparkl_tpu.ops import blocked_transfer as jbt
from wgsparkl_tpu.ops import kernel as jkernel
from wgsparkl_tpu.ops import particle_update as jpu
from wgsparkl_tpu.ops import rigid_cdf as jrc
from wgsparkl_tpu.ops import transfer as jtr
from wgsparkl_tpu.params import SimulationParams as JParams
from wgsparkl_tpu.pipeline import SimState as JState
from wgsparkl_tpu.pipeline import _node_cdf_full, _to_blocks
from wgsparkl_tpu.rigid import body as jbody
from wgsparkl_tpu.solver import Models as JModels
from wgsparkl_tpu.solver import Particles as JParticles
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch import math as tmath
from wgsparkl_tpu_torch.collision import cdf as tcdf
from wgsparkl_tpu_torch.collision import shapes as tshapes
from wgsparkl_tpu_torch.grid import GridConfig
from wgsparkl_tpu_torch.math import pose as tpose
from wgsparkl_tpu_torch.ops import blocked as tbk
from wgsparkl_tpu_torch.ops import blocked_transfer as tbt
from wgsparkl_tpu_torch.ops import eval_all
from wgsparkl_tpu_torch.ops import particle_update as tpu
from wgsparkl_tpu_torch.ops import rigid_cdf as trc
from wgsparkl_tpu_torch.ops import transfer as ttr
from wgsparkl_tpu_torch.rigid import body as tbody


def t(x):
    """A JAX array as a CPU tensor (uint32 as its int32 bit pattern)."""
    a = np.asarray(x)
    return torch.as_tensor(np.array(a.view(np.int32) if a.dtype == np.uint32 else a))


def close(out, ref, atol, scale=False):
    ref = np.asarray(ref)
    tol = atol * max(1.0, float(np.abs(ref).max())) if scale else atol
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=tol)


def _port_state(jstate):
    return interop.state_from_reference(jstate, "cpu")


# ---------------------------------------------------------------- dense transfer
@pytest.mark.parametrize("dim", [2, 3])
def test_p2g_g2p_match_jax(dim):
    """ops/transfer.p2g and g2p on a Particles state against JAX's
    (tests/test_torch_dense_transfer.py's inputs: random velocities, affine
    matrices and affinity words from numpy seed 7, the node CDF of its
    colliders): the grid within 1e-5 of its largest value, impulses within
    1e-5 of theirs, G2P and the rigid velocity within 1e-5, the gradient
    within 1e-5 of its largest value."""
    jd, jp, jb = _transfer_inputs(dim)
    cfg = jd.config
    nc = cfg.num_colliders
    node_dist, node_aff, node_closest = _node_cdf_full(jd.state, jb, cfg)
    pc = jcdf.particle_cdf_update(jp.pos, jp.cdf_affinity, node_dist, node_aff,
                                  cfg.grid, nc)
    jp = jp.replace(cdf_normal=pc["normal"], cdf_signed_distance=pc["signed_distance"],
                    cdf_affinity=pc["affinity"])
    gm, gmass, lin, ang = jtr.p2g(jp, jd.state.models, jb, node_aff, node_closest,
                                  cfg.grid, nc)
    gvel = jtr.grid_update(gm, gmass, jd.params, cfg.grid)
    v, grad, rv = jtr.g2p(jp, jb, gvel, node_aff, node_closest, cfg.grid, nc)

    st = _port_state(jd.state.replace(particles=jp, bodies=jb))
    grid = interop.config_from_reference(cfg).grid
    out = ttr.p2g(st.particles, st.models, st.bodies, t(node_aff), t(node_closest),
                  grid, nc)
    for a, b in zip(out, (gm, gmass, lin, ang)):
        assert tuple(a.shape) == tuple(np.shape(b))
        assert float(np.abs(np.asarray(b)).max()) > 0.0
        close(a, b, 1e-5, scale=True)
    tv, tgrad, trv = ttr.g2p(st.particles, st.bodies, t(gvel), t(node_aff),
                             t(node_closest), grid, nc)
    close(tv, v, 1e-5)
    close(tgrad, grad, 1e-5, scale=True)
    assert float(np.abs(np.asarray(rv)).max()) > 0.0
    close(trv, rv, 1e-5)


def _update_inputs(dim, fracture):
    """(JAX particles, models, params, grid) of a particle update: 256
    particles, F = I + 0.05 noise (a fifth inverted), velocity gradients of
    +-20 / s, signed distances across the penetration threshold, unit
    normals and rigid velocities from numpy seed 11; half the lanes sand
    (Drucker-Prager), the rest elastic at phase 1 (with fracture: max
    stretch 1.02 on the elastic lanes, their stretches spread across it)."""
    rng = np.random.default_rng(11)
    n, h = 256, 0.25
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))  # noqa: E731
    f = np.eye(dim) + rng.uniform(-0.05, 0.05, (n, dim, dim))
    f[: n // 5, 0] *= -1.0
    if fracture:
        f[n // 2:] = np.eye(dim)
        f[n // 2:, 0, 0] = np.linspace(0.99, 1.05, n - n // 2)
    nrm = rng.normal(size=(n, dim))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    parts = JParticles.from_arrays(rng.uniform(0.0, 2.0, (n, dim)).astype(np.float32),
                                   rng.uniform(-1, 1, (n, dim)).astype(np.float32),
                                   density=1000.0, radius=h / 4)
    parts = parts.replace(def_grad=f32(f),
                          affine=f32(rng.uniform(-20, 20, (n, dim, dim))),
                          cdf_signed_distance=f32(rng.uniform(-0.1, 0.05, n)),
                          cdf_normal=f32(nrm),
                          cdf_rigid_vel=f32(rng.uniform(-1, 1, (n, dim))))
    m = JEC.from_young_modulus(1e6, 0.3)
    sand = np.arange(n) < n // 2
    dps = j_dp_arrays([JDP.new(1e6, 0.3)] * n)
    dp = {k: jnp.asarray(np.where(sand, np.asarray(v), -1.0).astype(np.float32))
          for k, v in dps.items()}
    models = JModels.from_arrays(n, m.lam, m.mu, dp=dp,
                                 phase=np.where(sand, 0.0, 1.0).astype(np.float32),
                                 max_stretch=np.where(sand, -1.0, 1.02 if fracture
                                                      else -1.0).astype(np.float32))
    params = JParams.new(dt=1e-3, gravity=[0.0, -9.81] + [0.0] * (dim - 2))
    grid = JGrid(shape=(16,) * dim, cell_width=h, origin_cell=(-4,) * dim)
    return parts, models, params, grid


@pytest.mark.parametrize("dim,model,fracture", [
    (3, "corotated", False), (3, "neo_hookean", False), (2, "corotated", False),
    (2, "neo_hookean", False), (3, "corotated", True), (2, "corotated", True)])
def test_particle_update_matches_jax(dim, model, fracture):
    """ops/particle_update.particle_update (kernel C's plain version on the
    state's rows) against JAX's: position 1e-5, velocity, F and the
    Drucker-Prager state 1e-4, the affine matrix 1e-4 of its largest value
    (another SVD), phases exactly; with fracture some lanes fail, not all."""
    jp, jm, jparams, jgrid = _update_inputs(dim, fracture)
    rp, rm = jpu.particle_update(jp, jm, jparams, jgrid, model)
    st = _port_state(JState(particles=jp, models=jm,
                            bodies=jbody.make_rigid_world(dim, 1)))
    params = interop.params_from_reference(jparams, "cpu")
    grid = GridConfig(jgrid.shape, jgrid.cell_width, jgrid.origin_cell)
    op, om = tpu.particle_update(st.particles, st.models, params, grid, model)
    close(op.pos, rp.pos, 1e-5)
    close(op.vel, rp.vel, 1e-4)
    close(op.def_grad, rp.def_grad, 1e-4)
    close(op.affine, rp.affine, 1e-4, scale=True)
    np.testing.assert_array_equal(om.phase.numpy(), np.asarray(rm.phase))
    for k, v in rm.dp_state.items():
        close(om.dp_state[k], v, 1e-4)
    assert torch.equal(op.cdf_rigid_vel, st.particles.cdf_rigid_vel)
    assert om.mat_table is None and op.ids is st.particles.ids
    if fracture:
        failed = (np.asarray(rm.phase) == 0.0)[len(rm.phase) // 2:]
        assert failed.any() and not failed.all()


def test_particle_update_channels_2d_matches_jax():
    """The 2D channel form with JAX's arguments on _update_inputs' lanes."""
    jp, jm, jparams, jgrid = _update_inputs(2, False)
    ch = {"pos": [jp.pos[:, a] for a in range(2)], "vel": [jp.vel[:, a] for a in range(2)],
          "grad": {(i, j): jp.affine[:, i, j] for i in range(2) for j in range(2)},
          "F": {(i, j): jp.def_grad[:, i, j] for i in range(2) for j in range(2)},
          "sd": jp.cdf_signed_distance, "normal": [jp.cdf_normal[:, a] for a in range(2)],
          "rigid_vel": [jp.cdf_rigid_vel[:, a] for a in range(2)], "mass": jp.mass,
          "vol0": jp.init_volume, "lam": jm.lam, "mu": jm.mu, "dp": jm.dp,
          "dps": jm.dp_state, "phase": jm.phase, "stretch": jm.max_stretch}
    ref = jpu.particle_update_channels_2d(ch, jparams, jgrid)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        return t(x)

    out = tpu.particle_update_channels_2d(conv(ch), interop.params_from_reference(
        jparams, "cpu"), GridConfig(jgrid.shape, jgrid.cell_width, jgrid.origin_cell))
    for i in range(2):
        close(out["pos"][i], ref["pos"][i], 1e-5)
        close(out["vel"][i], ref["vel"][i], 1e-4)
    for k in ref["F"]:
        close(out["F"][k], ref["F"][k], 1e-4)
    np.testing.assert_array_equal(out["phase"].numpy(), np.asarray(ref["phase"]))


@pytest.mark.parametrize("dim", [2, 3])
def test_node_cdf_matches_jax(dim):
    """collision/cdf.node_cdf at the grid's nodes against JAX's (its world
    projection against the port's local one): distances within 1e-5,
    closest colliders and affinity words equal off the few nodes within
    1e-5 of the 1.5-cell reach, where roundoff may tip the box test."""
    jd, _, jb = _transfer_inputs(dim)
    cfg = jd.config
    pts = cfg.grid.node_positions()
    rd, ra, rc = jcdf.node_cdf(cfg.collider_types, jb.shape_params, jb.rot, jb.pos, pts,
                               cfg.grid.cell_width)
    od, oa, oc = tcdf.node_cdf(cfg.collider_types, t(jb.shape_params), t(jb.rot),
                               t(jb.pos), t(pts), cfg.grid.cell_width)
    same = (oa.numpy().view(np.uint32) == np.asarray(ra)) & (oc.numpy() == np.asarray(rc))
    assert (~same).sum() <= 0.001 * same.size and (np.asarray(rc) >= 0).sum() > 100
    both = same & (np.asarray(rc) >= 0)
    np.testing.assert_allclose(od.numpy()[both], np.asarray(rd)[both], rtol=0, atol=1e-5)


@pytest.mark.parametrize("dim", [2, 3])
def test_blocked_transfer_matches_jax(dim):
    """ops/blocked_transfer.p2g_blocked and g2p_blocked on JAX's sorted
    particles, job table and block-major node CDF (tests/test_blocked.py's
    3D scene with bodies; a 2D sand column on a floor), lowered into the
    floor: the block-major grid within 1e-5 of its largest value, impulses
    within 1e-5 of theirs, velocities within 1e-5, gradients within 1e-5 of
    their largest value."""
    from wgsparkl_tpu import scenes as jscenes

    if dim == 3:
        jd = _scene_3d(True)[1]
    else:
        jd = jscenes.sand_column_2d(nx=16, ny=32, cell_width=0.5, transfer="blocked",
                                    group=64, job_chunk=8)
    cfg, grid = jd.config, jd.config.grid
    nc = cfg.num_colliders
    p = jd.state.particles
    p = p.replace(pos=p.pos - jnp.asarray([0.0, 1.0] + [0.0] * (dim - 2)),
                  vel=jnp.asarray(np.random.default_rng(5).uniform(
                      -1, 1, p.vel.shape).astype(np.float32)))
    bodies = jbody.update_world_mass_properties(jd.state.bodies)
    ids, _ = jbk.particle_block_ids(p.pos, grid)
    (p, _), sorted_ids, _ = jbk.sort_by_block((p, jd.state.models), ids)
    jobs = jbk.build_jobs(sorted_ids, int(np.prod(jbk.num_blocks(grid))), cfg.group,
                          cfg.max_jobs)
    node_dist, node_aff, node_closest = _node_cdf_full(jd.state, bodies, cfg)
    pc = jcdf.particle_cdf_update(p.pos, p.cdf_affinity, node_dist, node_aff, grid, nc)
    sp = {"pos": p.pos, "vel": p.vel, "mass": p.mass, "affine": p.affine,
          "aff": pc["affinity"], "normal": pc["normal"]}
    gaff = _to_blocks(node_aff, grid, jnp.uint32(0))
    gcl = _to_blocks(node_closest, grid, -1)
    mm, lin, ang = jbt.p2g_blocked(sp, jobs, bodies, gaff, gcl, grid, nc, cfg.group,
                                   cfg.job_chunk)
    from wgsparkl_tpu.pipeline import _grid_velocity

    vel_b = _grid_velocity(mm, jd.params, grid, dim)
    v, grad = jbt.g2p_blocked(sp, jobs, bodies, vel_b, gaff, gcl, grid, nc, cfg.group,
                              cfg.job_chunk, p.count)

    tgrid = interop.config_from_reference(cfg).grid
    tbodies = _port_state(jd.state.replace(bodies=bodies)).bodies
    tsp = {k: t(x) for k, x in sp.items()}
    tjobs = {k: t(x) for k, x in jobs.items()}
    out = tbt.p2g_blocked(tsp, tjobs, tbodies, t(gaff), t(gcl), tgrid, nc, cfg.group,
                          cfg.job_chunk)
    for a, b in zip(out, (mm, lin, ang)):
        assert tuple(a.shape) == tuple(np.shape(b)) and np.abs(np.asarray(b)).max() > 0
        close(a, b, 1e-5, scale=True)
    tv, tgrad = tbt.g2p_blocked(tsp, tjobs, tbodies, t(vel_b), t(gaff), t(gcl), tgrid,
                                nc, cfg.group, cfg.job_chunk, p.count)
    close(tv, v, 1e-5)
    close(tgrad, grad, 1e-5, scale=True)


# ---------------------------------------------------------------- math
def _probe_matrices(dim, repeated=False):
    """From numpy seed 3: random, inverted (det < 0) and rank-deficient (a
    zero column; zero) matrices; with `repeated`, 16 rank-deficient ones
    whose last column repeats the first."""
    rng = np.random.default_rng(3)
    if repeated:
        f = rng.normal(size=(16, dim, dim))
        f[:, :, -1] = f[:, :, 0]
        return f.astype(np.float32)
    f = rng.normal(size=(64, dim, dim))
    inv = rng.normal(size=(16, dim, dim))
    inv *= -np.sign(np.linalg.det(inv))[:, None, None]
    rank = rng.normal(size=(8, dim, dim))
    rank[:, :, -1] = 0.0
    return np.concatenate([f, inv, rank, np.zeros((1, dim, dim))]).astype(np.float32)


def _svd_checks(f):
    """(U, S, V^T) of the port's svd on f, after checking what holds on every
    input: svd2x2 / svd3x3 give svd's bits; U and V orthonormal with det +1;
    S finite and sorted descending with sign(det F) on the last value."""
    dim = f.shape[-1]
    u, s, vt = tmath.svd(torch.as_tensor(f))
    u2, s2, vt2 = (tmath.svd2x2 if dim == 2 else tmath.svd3x3)(torch.as_tensor(f))
    assert torch.equal(u, u2) and torch.equal(s, s2) and torch.equal(vt, vt2)
    eye = np.broadcast_to(np.eye(dim), f.shape)
    for q in (u.numpy(), vt.numpy()):
        np.testing.assert_allclose(q @ np.swapaxes(q, -1, -2), eye, atol=1e-5)
        np.testing.assert_allclose(np.linalg.det(q), 1.0, atol=1e-5)
    sv = s.numpy()
    assert np.isfinite(sv).all() and (sv[:, :-1] >= np.abs(sv[:, 1:]) - 1e-6).all()
    det = np.linalg.det(f.astype(np.float64))
    assert (sv[det < -1e-6, -1] < 0).all() and (sv[det > 1e-6, -1] > 0).all()
    return u, s, vt


def _recompose_err(u, s, vt, f):
    """|U diag(S) V^T - F| per matrix, relative to max(1, its largest entry)."""
    rec = tmath.recompose(u, s, vt).numpy()
    return np.abs(rec - f).max(axis=(1, 2)) / np.maximum(np.abs(f).max(axis=(1, 2)), 1.0)


@pytest.mark.parametrize("dim", [2, 3])
def test_svd_matrix_forms(dim):
    """svd2x2 / svd3x3 / svd and recompose on random, inverted and
    rank-deficient (a zero column, zero) F: _svd_checks, U diag(S) V^T
    within 1e-5 of F relative to its largest entry, S^2 within 1e-5 of
    JAX's relative to the largest, the same signs; svd refuses other
    sizes."""
    f = _probe_matrices(dim)
    assert (np.linalg.det(f.astype(np.float64)) < -1e-6).sum() >= 16
    u, s, vt = _svd_checks(f)
    assert _recompose_err(u, s, vt, f).max() <= 1e-5
    # Both packages take the values as square roots of F^T F's eigenvalues:
    # those agree to 1e-5 of the largest (a small value's root amplifies
    # their roundoff: 4.2e-5 on a value of 2.7e-4 here).
    js = np.asarray(jmath.svd(jnp.asarray(f))[1])
    sv = s.numpy()
    lam_tol = 1e-5 * np.maximum(js[:, :1] ** 2, 1.0)
    assert (np.abs(sv * np.abs(sv) - js * np.abs(js)) <= lam_tol).all()
    np.testing.assert_array_equal(np.sign(sv), np.sign(js))
    with pytest.raises(ValueError):
        tmath.svd(torch.zeros(2, 4, 4))


@pytest.mark.parametrize("dim", [2, 3])
def test_svd_repeated_columns(dim):
    """Rank-deficient F whose last column repeats the first: _svd_checks
    hold.  Neither package recomposes all of them within 1e-5, and the
    port keeps the JAX package's algorithm: in 3D the Jacobi sweeps on F^T
    F resolve the zero value only to ~sqrt(eps) |F| (recompose within 1e-3;
    on seed 3 the port 4.3e-4 and JAX 1.6e-4 at worst); in 2D, where the
    symmetric factor's diagonal comes out exactly equal, the Givens
    rotation's tau is 0, sign(0) = 0 gives no rotation and S = (s, s), so
    such an F recomposes wrongly in both packages (ROADMAP queue 3; XLA's
    fused multiply-adds move some of these lanes off the exact tie, so the
    packages differ there).  Every other 2D lane recomposes within 1e-5."""
    f = _probe_matrices(dim, repeated=True)
    u, s, vt = _svd_checks(f)
    err = _recompose_err(u, s, vt, f)
    if dim == 3:
        assert err.max() <= 1e-3
    else:
        sv = s.numpy()
        tie = sv[:, 0] == sv[:, 1]
        assert (err[~tie] <= 1e-5).all() and (~tie).any()


def test_pose_helpers_match_jax():
    """quat_identity, rot2_identity, rot_identity exactly; quat_from_axis_angle
    and inv_transform_point (2D and 3D) within 1e-6."""
    rng = np.random.default_rng(9)
    assert torch.equal(tpose.quat_identity((3,), device="cpu"),
                       t(jpose.quat_identity((3,))))
    assert torch.equal(tpose.rot2_identity((2, 2), device="cpu"),
                       t(jpose.rot2_identity((2, 2))))
    for d in (2, 3):
        assert torch.equal(tpose.rot_identity(d, (4,), device="cpu"),
                           t(jpose.rot_identity(d, (4,))))
    axis = rng.normal(size=(8, 3)).astype(np.float32)
    ang = rng.uniform(-3, 3, 8).astype(np.float32)
    q = tpose.quat_from_axis_angle(torch.as_tensor(axis), torch.as_tensor(ang))
    jq = jpose.quat_from_axis_angle(jnp.asarray(axis), jnp.asarray(ang))
    close(q, jq, 1e-6)
    for rot, d in ((jq, 3), (jpose.rot2_from_angle(jnp.asarray(ang)), 2)):
        tr = rng.normal(size=(8, d)).astype(np.float32)
        p = rng.normal(size=(8, d)).astype(np.float32)
        ref = jpose.inv_transform_point(rot, jnp.asarray(tr), jnp.asarray(p))
        out = tpose.inv_transform_point(t(rot), torch.as_tensor(tr), torch.as_tensor(p))
        close(out, ref, 1e-6)
        close(tpose.transform_point(t(rot), torch.as_tensor(tr), out), p, 1e-5)


@pytest.mark.parametrize("dim", [2, 3])
def test_rigid_world_helpers_match_jax(dim):
    """make_rigid_world exactly, velocity_at_point within 1e-6, BodyCoupling
    and the rigid package's exports."""
    from wgsparkl_tpu_torch.rigid import BodyCoupling, RigidWorld

    tw = tbody.make_rigid_world(dim, 3, device="cpu")
    jw = jbody.make_rigid_world(dim, 3)
    assert isinstance(tw, RigidWorld)
    for f in ("rot", "pos", "linvel", "angvel", "inv_mass", "inv_inertia_local",
              "shape_params"):
        assert torch.equal(getattr(tw, f), t(getattr(jw, f))), f
    rng = np.random.default_rng(4)
    a = 3 if dim == 3 else 1
    jw = jw.replace(linvel=jnp.asarray(rng.normal(size=(3, dim)).astype(np.float32)),
                    angvel=jnp.asarray(rng.normal(size=(3, a)).astype(np.float32)),
                    world_com=jnp.asarray(rng.normal(size=(3, dim)).astype(np.float32)))
    idx = rng.integers(0, 3, (5, 4)).astype(np.int32)
    pts = rng.normal(size=(5, 4, dim)).astype(np.float32)
    ref = jbody.velocity_at_point(jw, jnp.asarray(idx), jnp.asarray(pts))
    tw = tbody.RigidWorld(**{f: t(getattr(jw, f)) for f in (
        "rot", "pos", "linvel", "angvel", "local_com", "world_com", "inv_mass",
        "inv_inertia_local", "inv_inertia_world", "shape_params")})
    out = tbody.velocity_at_point(tw, torch.as_tensor(idx), torch.as_tensor(pts))
    close(out, ref, 1e-6)
    two = BodyCoupling(two_way=torch.tensor([True, False]))
    assert two.two_way.dtype == torch.bool


@pytest.mark.parametrize("dim", [2, 3])
def test_grid_and_kernel_helpers_match_jax(dim):
    """GridConfig.node_positions exactly; eval_all within 1e-7; the ops
    package's exports."""
    from wgsparkl_tpu_torch import ops

    jg = JGrid(shape=(8, 12, 4)[:dim], cell_width=0.3, origin_cell=(-2, 3, 1)[:dim])
    tg = GridConfig(jg.shape, jg.cell_width, jg.origin_cell)
    assert torch.equal(tg.node_positions("cpu"), t(jg.node_positions()))
    x = np.random.default_rng(2).uniform(0.5, 1.5, (7, dim)).astype(np.float32)
    close(eval_all(torch.as_tensor(x)), jkernel.eval_all(jnp.asarray(x)), 1e-7)
    assert ops.inv_d(0.5) == jkernel.inv_d(0.5)
    np.testing.assert_array_equal(ops.stencil_offsets(dim), jkernel.stencil_offsets(dim))


def test_closest_points_match_jax():
    """closest_point_on_triangles (every vertex, edge and face region) and
    closest_point_on_segments (2D and 3D) within 1e-6."""
    rng = np.random.default_rng(6)
    tri = rng.normal(size=(3, 200, 3)).astype(np.float32)
    p = (3.0 * rng.normal(size=(200, 3))).astype(np.float32)
    ref = jshapes.closest_point_on_triangles(*map(jnp.asarray, (p, *tri)))
    out = tshapes.closest_point_on_triangles(*map(torch.as_tensor, (p, *tri)))
    close(out, ref, 1e-6, scale=True)
    for d in (2, 3):
        seg = rng.normal(size=(2, 100, d)).astype(np.float32)
        q = (2.0 * rng.normal(size=(100, d))).astype(np.float32)
        ref = jshapes.closest_point_on_segments(*map(jnp.asarray, (q, *seg)))
        out = tshapes.closest_point_on_segments(*map(torch.as_tensor, (q, *seg)))
        close(out, ref, 1e-6, scale=True)


# ---------------------------------------------------------------- block geometry
@pytest.mark.parametrize("dim,by", [(2, 4), (3, 4), (3, 8)])
def test_block_geometry_exact(dim, by):
    """block_size, window_size, window_node_offsets, octant_flat_offsets,
    particle_block_ids (ids and block coordinates) and its channel form,
    sort_by_block (sorted ids, permutation, the sorted state),
    window_node_positions exactly; window_weights within 1e-7."""
    rng = np.random.default_rng(8)
    assert tbk.block_size(dim) == jbk.block_size(dim)
    assert tbk.window_size(dim) == jbk.window_size(dim)
    np.testing.assert_array_equal(tbk.window_node_offsets(dim, by),
                                  jbk.window_node_offsets(dim, by))
    shape = (16, 32, 12)[:dim] if dim == 3 else (16, 24)
    jg = JGrid(shape=shape, cell_width=0.5, origin_cell=(-3, 2, 0)[:dim])
    tg = GridConfig(jg.shape, jg.cell_width, jg.origin_cell)
    nb = jbk.num_blocks(jg, by)
    assert tbk.octant_flat_offsets(nb) == jbk.octant_flat_offsets(nb)
    lo = np.asarray(jg.origin_cell) * jg.cell_width
    pos = rng.uniform(lo - 1.0, lo + np.asarray(shape) * jg.cell_width + 1.0,
                      (300, dim)).astype(np.float32)
    jids, jblk = jbk.particle_block_ids(jnp.asarray(pos), jg, by)
    tids, tblk = tbk.particle_block_ids(torch.as_tensor(pos), tg, by)
    assert torch.equal(tids, t(jids)) and torch.equal(tblk, t(jblk))
    assert (np.asarray(jids) == np.prod(nb)).any()
    ch = tbk.particle_block_ids_ch([torch.as_tensor(pos[:, a]) for a in range(dim)], tg, by)
    assert torch.equal(ch, t(jbk.particle_block_ids_ch([jnp.asarray(pos[:, a])
                                                        for a in range(dim)], jg, by)))
    jp = JParticles.from_arrays(pos, density=1000.0, radius=0.1)
    jm = JModels.from_arrays(300, 1.0, 2.0)
    (sjp, _), jsids, jperm = jbk.sort_by_block((jp, jm), jids)
    st = _port_state(JState(particles=jp, models=jm,
                            bodies=jbody.make_rigid_world(dim, 1)))
    (stp, stm), tsids, tperm = tbk.sort_by_block((st.particles, st.models), tids)
    assert torch.equal(tsids, t(jsids)) and torch.equal(tperm, t(jperm))
    assert torch.equal(stp.pos, t(sjp.pos)) and torch.equal(stp.ids, t(sjp.ids))
    assert torch.equal(stm.lam, st.models.lam[tperm.long()])
    inside = np.asarray(jids) < np.prod(nb)
    bc = np.asarray(jblk)[inside]
    jw = jbk.window_weights(jnp.asarray(pos[inside]), jnp.asarray(bc), jg, by)
    tw = tbk.window_weights(torch.as_tensor(pos[inside]), torch.as_tensor(bc), tg, by)
    close(tw[0], jw[0], 1e-7)
    assert torch.equal(tw[1], t(jw[1]))
    close(tw[2], jw[2], 1e-7)
    assert torch.equal(tbk.window_node_positions(torch.as_tensor(bc), tg, by),
                       t(jbk.window_node_positions(jnp.asarray(bc), jg, by)))


@pytest.mark.parametrize("dim", [2, 3])
def test_block_layouts_exact(dim):
    """rigid_cdf.blocks_to_flat against JAX's, and blocked.to_blocks /
    from_blocks against the JAX pipeline's _to_blocks, bit for bit."""
    jg = JGrid(shape=(8, 16, 12)[:dim] if dim == 3 else (16, 24), cell_width=0.5,
               origin_cell=(0,) * dim)
    tg = GridConfig(jg.shape, jg.cell_width, jg.origin_cell)
    flat = np.random.default_rng(1).normal(size=(jg.num_nodes, 3)).astype(np.float32)
    jb = _to_blocks(jnp.asarray(flat), jg, 0.0)
    tb = tbk.to_blocks(torch.as_tensor(flat), tg, 0.0)
    assert torch.equal(tb, t(jb))
    assert torch.equal(trc.blocks_to_flat(tb, tg), t(jrc.blocks_to_flat(jb, jg)))
    assert torch.equal(tbk.from_blocks(tb, tg), torch.as_tensor(flat))
