"""More than 128 distinct materials on the port's dense and blocked
transfers, against the JAX package's `substep` / `substep_blocked` (through
its `step`), and the pallas path's limit.

The scene of the fault: a collider-free 2D lattice of 16 x 16 particles,
spacing 0.25, from (2, 2), density 1000, radius 0.0625, each with its own
lambda (linspace(1e4, 2e4, 256)) and mu 1e4, cell width 0.5, grid [0, 8]^2,
dt 1e-3, 3 substeps; its 3D counterpart (16 x 4 x 4 particles from
(2, 2, 2) in [0, 8]^3, on a floor cuboid); and the 3D lattice with one
lambda and each particle's radius jittered (numpy default_rng(5), +-10%),
which makes each particle a material of its own too.  Every lattice starts
strained, F = diag(1.2, 0.85[, 1]), so that each particle's stress, and
with it the velocities and F, depends on its own constants: a port that
read another particle's material fails (`test_a_permuted_material_fails`).

Tolerances: positions, velocities and F 1e-6 (the packages sum P2G in other
orders: fp32 roundoff over 3 substeps, 1.2e-7 at most), affinity words and
ids exactly, and the constants rebuilt from the [16, 256] table (lam, mu,
init_volume, init_radius) bit for bit."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from wgsparkl_tpu.collision.shapes import Collider as JCollider
from wgsparkl_tpu.params import SimulationParams as JParams
from wgsparkl_tpu.pipeline import MpmData as JData
from wgsparkl_tpu.pipeline import RigidBodyDesc as JBody
from wgsparkl_tpu.pipeline import step as jstep
from wgsparkl_tpu.solver import Models as JModels
from wgsparkl_tpu.solver import Particles as JParticles
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch.collision.shapes import Collider
from wgsparkl_tpu_torch.params import SimulationParams
from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc, step
from wgsparkl_tpu_torch.solver import Models, Particles

_jstep = jax.jit(jstep, static_argnums=(2, 3))
SUBSTEPS = 3
TOL = 1e-6
# The lattices' initial deformation gradient (its first d diagonal entries).
STRAIN = (1.2, 0.85, 1.0)


def _scene(kind: str):
    """(positions, lam, radius, gravity, bounds, floor) of a scene."""
    if kind == "2d":
        xs = 2.0 + 0.25 * np.arange(16)
        pos = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
        return (pos.astype(np.float32), np.linspace(1e4, 2e4, 256), 0.0625,
                [0.0, -9.81], 8.0, False)
    g = np.meshgrid(2.0 + 0.25 * np.arange(16), 2.0 + 0.25 * np.arange(4),
                    2.0 + 0.25 * np.arange(4), indexing="ij")
    pos = np.stack([a.ravel() for a in g], -1).astype(np.float32)
    if kind == "3d":
        return pos, np.linspace(1e4, 2e4, 256), 0.0625, [0.0, -9.81, 0.0], 8.0, True
    rng = np.random.default_rng(5)
    radius = (0.0625 * (1.0 + rng.uniform(-0.1, 0.1, 256))).astype(np.float32)
    return pos, 1.5e4, radius, [0.0, -9.81, 0.0], 8.0, True


def _build(kind: str, transfer: str):
    """(JAX MpmData, port MpmData) of the same arrays, strained by STRAIN."""
    pos, lam, radius, gravity, top, floor = _scene(kind)
    d = pos.shape[1]
    bounds = (np.zeros(d), np.full(d, top))
    n = len(pos)
    jbodies = ([JBody(JCollider.cuboid(10.0, 0.5, 10.0), (4.0, 1.0, 4.0))]
               if floor else [])
    tbodies = ([RigidBodyDesc(Collider.cuboid(10.0, 0.5, 10.0), (4.0, 1.0, 4.0))]
               if floor else [])
    kw = dict(grid_bounds=bounds, transfer=transfer)
    if transfer != "dense":
        kw.update(group=64, job_chunk=8)
    jdata = JData(JParams.new(dt=1e-3, gravity=gravity),
                  JParticles.from_arrays(pos, density=1000.0, radius=radius),
                  JModels.from_arrays(n, lam, 1e4), jbodies, 0.5, **kw)
    tdata = MpmData(SimulationParams.new(dt=1e-3, gravity=gravity, device="cpu"),
                    Particles.from_arrays(pos, density=1000.0, radius=radius,
                                          device="cpu"),
                    Models.from_arrays(n, lam, 1e4, device="cpu"), tbodies, 0.5, **kw)
    f0 = np.broadcast_to(np.diag(np.float32(STRAIN[:d])), (n, d, d)).copy()
    jdata.state = jdata.state.replace(
        particles=jdata.state.particles.replace(def_grad=f0))
    tdata.state.particles.def_grad.copy_(torch.from_numpy(f0))
    return jdata, tdata


def _max_errors(out, ref):
    """Largest |port - JAX| of the positions, velocities and F."""
    return [float(np.abs(getattr(out.particles, f).numpy()
                         - np.asarray(getattr(ref.particles, f))).max())
            for f in ("pos", "vel", "def_grad")]


@pytest.mark.parametrize("transfer", ["dense", "blocked"])
@pytest.mark.parametrize("kind", ["2d", "3d", "3d_radius_jitter"])
def test_many_materials_match_jax(kind, transfer):
    jdata, tdata = _build(kind, transfer)
    n_mat = tdata.config.n_materials
    assert n_mat == 256 and tuple(tdata.state.models.mat_table.shape) == (16, 256)
    # The configuration is JAX's but for the material count, which JAX
    # keeps for its pallas path only.
    assert jdata.config.n_materials == 1 and jdata.state.models.mat_table is None
    assert dataclasses.replace(tdata.config, n_materials=1) == \
        interop.config_from_reference(jdata.config)
    ref = _jstep(jdata.state, jdata.params, jdata.config, SUBSTEPS)
    out = step(tdata.state, tdata.params, tdata.config, SUBSTEPS)
    rp, op = ref.particles, out.particles
    np.testing.assert_array_equal(op.ids.numpy(), np.asarray(rp.ids))
    np.testing.assert_allclose(op.pos.numpy(), np.asarray(rp.pos), rtol=0, atol=TOL)
    np.testing.assert_allclose(op.vel.numpy(), np.asarray(rp.vel), rtol=0, atol=TOL)
    np.testing.assert_allclose(op.def_grad.numpy(), np.asarray(rp.def_grad), rtol=0,
                               atol=TOL)
    np.testing.assert_array_equal(op.cdf_affinity.numpy().view(np.uint32),
                                  np.asarray(rp.cdf_affinity))
    for f in ("lam", "mu"):
        np.testing.assert_array_equal(getattr(out.models, f).numpy(),
                                      np.asarray(getattr(ref.models, f)))
    for f in ("init_volume", "init_radius"):
        np.testing.assert_array_equal(getattr(op, f).numpy(), np.asarray(getattr(rp, f)))
    assert float(np.abs(np.asarray(rp.vel)).max()) > 0.02     # it moved
    if kind != "2d":
        assert (np.asarray(rp.cdf_affinity) != 0).any()


@pytest.mark.parametrize("transfer", ["dense", "blocked"])
@pytest.mark.parametrize("kind", ["2d", "3d", "3d_radius_jitter"])
def test_a_permuted_material_fails(kind, transfer):
    """The comparison above tells one material from another: with the
    material ids reversed (particle k reads material 255 - k) the port's
    velocities and F leave JAX's by far more than the tolerance."""
    jdata, tdata = _build(kind, transfer)
    m = tdata.state.models
    flipped = dataclasses.replace(
        tdata.state, models=dataclasses.replace(m, mat_id=m.mat_id.flip(0)))
    ref = _jstep(jdata.state, jdata.params, jdata.config, SUBSTEPS)
    _, vel, def_grad = _max_errors(step(flipped, tdata.params, tdata.config, SUBSTEPS),
                                   ref)
    _, vel_ok, def_grad_ok = _max_errors(
        step(tdata.state, tdata.params, tdata.config, SUBSTEPS), ref)
    assert vel > 100 * TOL and def_grad > 5 * TOL, (vel, def_grad)
    assert vel_ok <= TOL and def_grad_ok <= TOL


def test_many_materials_from_the_reference_state():
    """step_dense gives a state without a material table (the JAX package's
    dense state) a [16, M] one of any size."""
    jdata, _ = _build("2d", "dense")
    cfg = interop.config_from_reference(jdata.config)
    out = step(interop.state_from_reference(jdata.state, "cpu"),
               interop.params_from_reference(jdata.params, "cpu"), cfg, SUBSTEPS)
    ref = _jstep(jdata.state, jdata.params, jdata.config, SUBSTEPS)
    np.testing.assert_allclose(out.particles.pos.numpy(), np.asarray(ref.particles.pos),
                               rtol=0, atol=TOL)
    np.testing.assert_array_equal(out.models.lam.numpy(), np.asarray(ref.models.lam))


@pytest.mark.parametrize("kind", ["2d", "3d_radius_jitter"])
def test_pallas_path_keeps_the_limit(kind):
    """The pallas path holds 128 materials and raises past them with the
    JAX package's message."""
    pos, lam, radius, gravity, top, _ = _scene(kind)
    d, n = pos.shape[1], len(pos)
    kw = dict(grid_bounds=(np.zeros(d), np.full(d, top)), transfer="pallas", group=64)
    with pytest.raises(ValueError) as jerr:
        JData(JParams.new(dt=1e-3, gravity=gravity),
              JParticles.from_arrays(pos, density=1000.0, radius=radius),
              JModels.from_arrays(n, lam, 1e4), [], 0.5, **kw)
    with pytest.raises(ValueError) as terr:
        MpmData(SimulationParams.new(dt=1e-3, gravity=gravity, device="cpu"),
                Particles.from_arrays(pos, density=1000.0, radius=radius, device="cpu"),
                Models.from_arrays(n, lam, 1e4, device="cpu"), [], 0.5, **kw)
    assert str(terr.value) == str(jerr.value)
    assert "transfer='blocked'/'dense'" in str(terr.value)
