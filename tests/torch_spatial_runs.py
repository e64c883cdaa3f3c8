"""The spatial (x-slab) step of both packages on tests/test_parallel.py's
scenes, for tests/test_torch_spatial*.py.

`run_cases` steps each case with the JAX package's make_sharded_step in
`jax.shard_map` over the first virtual CPU devices and with the port's
ranks (wgsparkl_tpu_torch/parallel/launch.py, gloo, one launch for every
case), both from the same JAX scene and spatial configuration (interop).
"""

import jax
import numpy as np
from jax.sharding import Mesh

import test_parallel as tp
from wgsparkl_tpu.parallel import make_sharded_step as jax_make_sharded_step
from wgsparkl_tpu.parallel import shard_state_spatial as jax_shard_state_spatial
from wgsparkl_tpu.parallel import spatial_config as jax_spatial_config
from wgsparkl_tpu.pipeline import MpmData as JMpmData
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch.parallel import domain, launch


def scene_2d():
    """tests/test_parallel.py:210-234's 2D column (64 x 16 particles with
    lateral velocities over a floor), as (particles, models, bodies,
    params, grid)."""
    from wgsparkl_tpu.collision.shapes import Collider
    from wgsparkl_tpu.grid import GridConfig
    from wgsparkl_tpu.models.elasticity import ElasticCoefficients
    from wgsparkl_tpu.params import SimulationParams
    from wgsparkl_tpu.pipeline import RigidBodyDesc
    from wgsparkl_tpu.solver import Models, Particles

    rng = np.random.default_rng(11)
    grid = GridConfig.from_bounds(np.array([0.0, 0.0]), np.array([120.0, 24.0]), 1.0)
    xs = np.arange(64) * 0.5 + 44.0
    ys = np.arange(16) * 0.5 + 2.0
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    n = len(pos)
    vel = np.zeros((n, 2), np.float32)
    vel[:, 0] = rng.uniform(-14.0, 14.0, n)
    particles = Particles.from_arrays(pos.astype(np.float32), vel, density=1000.0,
                                      radius=0.25)
    elast = ElasticCoefficients.from_young_modulus(1.0e6, 0.2)
    models = Models.from_arrays(n, elast.lam, elast.mu, phase=np.ones(n, np.float32))
    bodies = [RigidBodyDesc(Collider.cuboid(200.0, 1.0), (60.0, -0.9))]
    params = SimulationParams.new(dt=2e-3, gravity=np.array([0.0, -9.81]))
    return particles, models, bodies, params, grid


def run_cases(cases, world=2):
    """cases: {name: (scene, substeps, sparse, migration_cap, halo_cap)}.
    Returns {name: dict(n, jax_shards (the JAX package's sharded input),
    port_shards, jax (state), jax_diag, ranks (the port's results))}."""
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("dp",))
    out, jobs = {}, []
    for name, (scene, substeps, sparse, mcap, hcap) in cases.items():
        particles, models, bodies, params, grid = scene()
        data = JMpmData(params, particles, models, bodies, 1.0, grid=grid,
                        transfer="pallas", group=64, job_chunk=8, sparse=sparse)
        jcfg = jax_spatial_config(data.config, world, migration_cap=mcap, halo_cap=hcap)
        jin = jax_shard_state_spatial(data.state, mesh, jcfg)
        jout, jdiag = jax_make_sharded_step(jcfg, mesh, num_substeps=substeps,
                                            with_diag=True)(jin, data.params)
        state = interop.state_from_reference(data.state, "cpu")
        cfg = domain.spatial_config(interop.config_from_reference(data.config), world,
                                    migration_cap=mcap, halo_cap=hcap)
        assert cfg == interop.config_from_reference(jcfg)
        pparams = interop.params_from_reference(data.params, "cpu")
        shards = [domain.shard_state_spatial(state, cfg, r) for r in range(world)]
        jobs.append([(s, pparams, cfg, [substeps]) for s in shards])
        out[name] = dict(n=data.num_particles, jax_shards=jin, port_shards=shards,
                         jax=jout, jax_diag=jdiag)
    res = launch.run(launch.step_jobs, world,
                     rank_args=[([job[r] for job in jobs],) for r in range(world)])
    for i, name in enumerate(cases):
        out[name]["ranks"] = [res[r][i] for r in range(world)]
    return out


def live_by_id(pos, vel, ids, mass):
    """Positions and velocities of the live lanes (id >= 0, mass > 0), by id."""
    ids, mass = np.asarray(ids), np.asarray(mass)
    live = (ids >= 0) & (mass > 0)
    o = np.argsort(ids[live])
    return np.asarray(pos)[live][o], np.asarray(vel)[live][o], int(live.sum())


def check_case(run, atol_p=1e-4, atol_v=1e-3):
    """The port's spatial run against JAX's: the same slab chunks, every
    particle kept in both, positions and velocities by id within JAX's own
    spatial bounds (tests/test_parallel.py:196-203), the counters per rank
    equal, and the bodies bit-equal across the ranks."""
    st0 = domain.gather_state(run["port_shards"])
    jin = run["jax_shards"]
    np.testing.assert_array_equal(st0.particles.ids.numpy(), np.asarray(jin.particles.ids))
    np.testing.assert_array_equal(st0.particles.pos.numpy(), np.asarray(jin.particles.pos))
    ranks = run["ranks"]
    st = domain.gather_state([r["states"][-1] for r in ranks])
    pos, vel, live = live_by_id(st.particles.pos, st.particles.vel, st.particles.ids,
                                st.particles.mass)
    jout = run["jax"]
    jpos, jvel, jlive = live_by_id(jout.particles.pos, jout.particles.vel,
                                   jout.particles.ids, jout.particles.mass)
    assert live == jlive == run["n"], (live, jlive, run["n"])
    np.testing.assert_allclose(pos, jpos, atol=atol_p)
    np.testing.assert_allclose(vel, jvel, atol=atol_v)
    for f in ("migration_dropped", "live_lost", "halo_dropped", "job_overflow"):
        for r in ranks:
            np.testing.assert_array_equal(r["diags"][-1][f],
                                          np.asarray(getattr(run["jax_diag"], f)))
    b0, b1 = ranks[0]["states"][-1].bodies, ranks[-1]["states"][-1].bodies
    for f in ("pos", "rot", "linvel", "angvel"):
        assert np.array_equal(getattr(b0, f).view(np.uint32), getattr(b1, f).view(np.uint32))
    return ranks


__all__ = ["check_case", "live_by_id", "run_cases", "scene_2d", "tp"]
