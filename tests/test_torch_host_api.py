"""The port's host-side builder API against the JAX package's:
ParticlePhase, ParticleDynamics.with_density, Particle and the
`from_particles` / `from_arrays` builders (arrays equal bit for bit), the
models' state types and matrix forms, the packages' exports, and
MpmPipeline against `step`.

Tolerances: the matrix-form stresses and return map go through the port's
channel forms, JAX's through its einsum matrix forms, so they agree to fp32
roundoff of the largest entry: 2e-6 x max(1, max |ref|) (the Jacobi SVD,
an einsum against a channel sum)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wgsparkl_tpu.collision as jcollision
import wgsparkl_tpu.models as jmodels
import wgsparkl_tpu.utils as jutils
from wgsparkl_tpu import solver as js
from wgsparkl_tpu.models.elasticity import elastic_arrays as j_elastic_arrays
import wgsparkl_tpu_torch.collision as tcollision
import wgsparkl_tpu_torch.models as tmodels
import wgsparkl_tpu_torch.utils as tutils
from wgsparkl_tpu_torch import scenes
from wgsparkl_tpu_torch import solver as ts
from wgsparkl_tpu_torch.models.elasticity import elastic_arrays
from wgsparkl_tpu_torch.pipeline import MpmPipeline, step


def _host_particles(mod, dim, n=40, seed=0):
    """n Particle objects of `mod` (either package's solver) made from a
    numpy seed: every third without plasticity, every second without a
    phase."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pos = tuple(float(x) for x in rng.uniform(-1.0, 1.0, dim))
        dyn = mod.ParticleDynamics.with_density(float(rng.uniform(0.05, 0.2)),
                                                float(rng.uniform(500, 3000)), dim)
        if i % 4 == 1:
            dyn = dataclasses.replace(dyn, velocity=tuple(
                float(v) for v in rng.uniform(-2.0, 2.0, dim)))
        el = mod.ElasticCoefficients.from_young_modulus(float(rng.uniform(1e5, 1e7)),
                                                        0.3)
        dp = None if i % 3 == 0 else mod.DruckerPrager.new(float(rng.uniform(1e5, 1e7)),
                                                            0.2)
        ph = None if i % 2 == 0 else mod.ParticlePhase(1.0, float(rng.uniform(1.1, 1.5)))
        out.append(mod.Particle(pos, dyn, el, dp, ph))
    return out


def _eq(t, a):
    np.testing.assert_array_equal(t.numpy() if isinstance(t, torch.Tensor) else t,
                                  np.asarray(a))


@pytest.mark.parametrize("dim", [2, 3])
def test_from_particles_equals_jax(dim):
    jp = _host_particles(js, dim)
    tp = _host_particles(ts, dim)
    assert [dataclasses.asdict(p) for p in tp] == [dataclasses.asdict(p) for p in jp]
    jpart, tpart = js.Particles.from_particles(jp), ts.Particles.from_particles(tp, "cpu")
    for f in ("pos", "vel", "def_grad", "affine", "init_volume", "init_radius", "mass",
              "cdf_normal", "cdf_rigid_vel", "cdf_signed_distance", "ids"):
        _eq(getattr(tpart, f), getattr(jpart, f))
    _eq(tpart.cdf_affinity.numpy().view(np.uint32), jpart.cdf_affinity)
    jm, tm = js.Models.from_particles(jp), ts.Models.from_particles(tp, "cpu")
    for f in ("lam", "mu", "phase", "max_stretch"):
        _eq(getattr(tm, f), getattr(jm, f))
    for k in jm.dp:
        _eq(tm.dp[k], jm.dp[k])
    for k in jm.dp_state:
        _eq(tm.dp_state[k], jm.dp_state[k])
    assert tm.mat_id is None and tm.mat_table is None


def test_from_arrays_both_forms_equal_jax():
    rng = np.random.default_rng(1)
    pos = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    vel = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    rad = rng.uniform(0.05, 0.1, 50).astype(np.float32)
    cases = [dict(density=1200.0, radius=rad), dict(density=1200.0, radius=0.1),
             dict(mass=rng.uniform(1, 2, 50), init_volume=0.001, radius=rad)]
    for kw in cases:
        for v in (None, vel, (0.5, -1.0, 0.0)):
            j = js.Particles.from_arrays(pos, v, **kw)
            t = ts.Particles.from_arrays(pos, v, device="cpu", **kw)
            for f in ("pos", "vel", "init_volume", "init_radius", "mass", "def_grad"):
                _eq(getattr(t, f), getattr(j, f))
    with pytest.raises(ValueError) as jerr:
        js.Particles.from_arrays(pos, density=1.0)
    with pytest.raises(ValueError) as terr:
        ts.Particles.from_arrays(pos, density=1.0, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_state_types_and_exports_equal_jax():
    for dim in (2, 3):
        assert dataclasses.asdict(ts.ParticleDynamics.with_density(0.1, 900.0, dim)) \
            == dataclasses.asdict(js.ParticleDynamics.with_density(0.1, 900.0, dim))
    assert dataclasses.asdict(ts.ParticlePhase()) == dataclasses.asdict(js.ParticlePhase())
    assert dataclasses.asdict(tmodels.DruckerPrager.disabled()) == \
        dataclasses.asdict(jmodels.DruckerPrager.disabled())
    assert dataclasses.asdict(tmodels.DruckerPragerState()) == \
        dataclasses.asdict(jmodels.DruckerPragerState())
    coeffs = [jmodels.ElasticCoefficients.from_young_modulus(e, 0.25)
              for e in (1e5, 2e6, 3e7)]
    for a, b in zip(elastic_arrays(coeffs), j_elastic_arrays(coeffs)):
        np.testing.assert_array_equal(a, b)
    for tmod, jmod in ((tmodels, jmodels), (tcollision, jcollision), (tutils, jutils)):
        assert tmod.__all__ == jmod.__all__
        for name in tmod.__all__:
            assert getattr(tmod, name) is not None
    for name in ("SHAPE_CUBOID", "SHAPE_BALL", "SHAPE_CAPSULE", "SHAPE_HALFSPACE",
                 "SHAPE_POLYLINE", "SHAPE_TRIMESH", "SHAPE_HEIGHTFIELD"):
        assert getattr(tcollision, name) == getattr(jcollision, name)


def _close(t, ref, tol=2e-6):
    ref = np.asarray(ref)
    np.testing.assert_allclose(t.numpy(), ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("dim", [2, 3])
def test_matrix_forms_equal_jax(dim):
    """The stresses and the Drucker-Prager return map on [64, d, d] F made
    from a numpy seed: stretched and compressed near the identity, so that
    the return map takes each of its branches."""
    rng = np.random.default_rng(2 + dim)
    n = 64
    f = (np.eye(dim) + 0.15 * rng.standard_normal((n, dim, dim))).astype(np.float32)
    f[: n // 4] *= np.float32(0.9)      # compressed: case C
    lam = rng.uniform(1e5, 1e6, n).astype(np.float32)
    mu = rng.uniform(1e5, 1e6, n).astype(np.float32)
    tf = torch.as_tensor(f)
    for name in ("kirchoff_stress_corotated", "kirchoff_stress_neo_hookean"):
        ref = getattr(jmodels, name)(jnp.asarray(lam), jnp.asarray(mu), jnp.asarray(f))
        out = getattr(tmodels, name)(torch.as_tensor(lam), torch.as_tensor(mu), tf)
        assert out.shape == (n, dim, dim)
        _close(out, ref)
    dp = {k: np.full(n, v, np.float32) for k, v in dataclasses.asdict(
        jmodels.DruckerPrager.new(1e6, 0.2)).items()}
    dp["lam"][::7] = -1.0               # plasticity disabled on some lanes
    state = {"det": rng.uniform(0.9, 1.1, n).astype(np.float32),
             "hardening": rng.uniform(0.5, 2.0, n).astype(np.float32),
             "log_vol_gain": rng.uniform(-0.1, 0.1, n).astype(np.float32)}
    jst, jf = jmodels.drucker_prager_project(
        {k: jnp.asarray(v) for k, v in dp.items()},
        {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(f))
    tst, tf2 = tmodels.drucker_prager_project(
        {k: torch.as_tensor(v) for k, v in dp.items()},
        {k: torch.as_tensor(v) for k, v in state.items()}, tf)
    _close(tf2, jf, 1e-5)
    for k in state:
        _close(tst[k], jst[k], 1e-5)
    changed = ~np.all(np.isclose(np.asarray(jf), f), axis=(1, 2))
    assert changed.sum() >= 8 and (~changed).sum() >= 8


def test_mpm_pipeline_equals_step():
    """MpmPipeline.step and step_fn are `step` on the scene's state."""
    data = scenes.sand_box_3d(nxz=4, ny=8, device="cpu", by=8, group=256)
    state0 = data.state
    ref = step(state0, data.params, data.config, 3)
    fn = MpmPipeline().step_fn(data.config, 3)
    by_fn = fn(state0, data.params)
    diag = MpmPipeline().step(data, 3)
    assert not diag.any_overflow()
    for out in (by_fn, data.state):
        for f in ("pos", "vel", "def_grad", "affine", "cdf_affinity", "ids"):
            assert torch.equal(getattr(out.particles, f), getattr(ref.particles, f))
        for f in ("pos", "rot", "linvel", "angvel"):
            assert torch.equal(getattr(out.bodies, f), getattr(ref.bodies, f))
