"""The port's particle-sharded step against the JAX package's
make_sharded_step, on 2 ranks.

The port's ranks run through wgsparkl_tpu_torch/parallel/launch.py on gloo
(spawned CPU processes, one launch for every scene); the JAX step runs in
`jax.shard_map` over the first 2 virtual CPU devices of tests/conftest.py,
as tests/test_parallel.py runs it.  Both start from the same JAX scene
(interop).  Scenes and bounds:

  * `sand_box_3d(nxz=4, ny=16, cell_width=1.0)` on the dense transfer,
    3 substeps: 2e-6 in position and 2e-5 in velocity, the JAX package's
    own bound for its sharded step (tests/test_parallel.py:30-35);
  * the same on the pallas transfer, group 64, 12 substeps, matched by id:
    1e-5 and 1e-4 (tests/test_parallel.py:66-73);
  * a 2D sand column on the pallas transfer, 12 substeps, as the last.

Each is also held against the port's own single-rank step, and the bodies
are bit-equal across the ranks.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from wgsparkl_tpu import scenes as jscenes
from wgsparkl_tpu.parallel import make_sharded_step as jax_make_sharded_step
from wgsparkl_tpu.parallel import shard_state as jax_shard_state
from wgsparkl_tpu.pipeline import MpmData as JMpmData
from wgsparkl_tpu_torch import interop, scenes
from wgsparkl_tpu_torch.parallel import domain, launch
from wgsparkl_tpu_torch.parallel.comm import Comm, check_devices
from wgsparkl_tpu_torch.pipeline import StepDiag, step

WORLD = 2
# name: (substeps, position and velocity bounds)
CASES = {"dense": (3, 2e-6, 2e-5), "pallas": (12, 1e-5, 1e-4),
         "pallas_2d": (12, 1e-5, 1e-4)}


def _jax_data(name):
    if name == "pallas_2d":
        return jscenes.sand_column_2d(nx=16, ny=16, cell_width=0.5, transfer="pallas",
                                      group=64, job_chunk=8)
    base = jscenes.sand_box_3d(nxz=4, ny=16, cell_width=1.0)
    if name == "dense":
        return base
    return JMpmData(base.params, base.state.particles, base.state.models,
                    base.bodies_desc, 1.0, grid=base.config.grid, transfer="pallas",
                    group=64, job_chunk=8)


def _port(jd):
    return (interop.state_from_reference(jd.state, "cpu"),
            interop.params_from_reference(jd.params, "cpu"),
            interop.config_from_reference(jd.config))


@pytest.fixture(scope="module")
def runs():
    """Per case: the JAX sharded state, the port's single-rank state and the
    port's ranks' results (one launch for all cases)."""
    out, jobs = {}, []
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("dp",))
    for name, (substeps, _, _) in CASES.items():
        jd = _jax_data(name)
        assert jd.num_particles % WORLD == 0
        jout = jax_make_sharded_step(jd.config, mesh, num_substeps=substeps)(
            jax_shard_state(jd.state, mesh), jd.params)
        state, params, cfg = _port(jd)
        single = step(state, params, cfg, substeps)
        out[name] = (jout, single)
        jobs.append([(domain.shard_state(state, r, WORLD), params, cfg, [substeps])
                     for r in range(WORLD)])
    res = launch.run(launch.step_jobs, WORLD,
                     rank_args=[([job[r] for job in jobs],) for r in range(WORLD)])
    return {name: out[name] + ([res[r][i] for r in range(WORLD)],)
            for i, name in enumerate(CASES)}


def _by_id(pos, vel, ids):
    o = np.argsort(ids)
    return np.asarray(pos)[o], np.asarray(vel)[o]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_jax(runs, name):
    _, atol_p, atol_v = CASES[name]
    jout, single, ranks = runs[name]
    st = domain.gather_state([r["states"][-1] for r in ranks])
    pos, vel = _by_id(st.particles.pos, st.particles.vel, st.particles.ids)
    jpos, jvel = _by_id(jout.particles.pos, jout.particles.vel, jout.particles.ids)
    np.testing.assert_allclose(pos, jpos, atol=atol_p)
    np.testing.assert_allclose(vel, jvel, atol=atol_v)
    np.testing.assert_allclose(st.bodies.pos, np.asarray(jout.bodies.pos), atol=1e-6)
    assert not any(np.any(r["diags"][-1][k]) for r in ranks for k in StepDiag.FAULTS)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_single_rank(runs, name):
    """The ranks together against the port's unsharded step; the bodies,
    updated on every rank from the summed impulses, bit-equal across
    ranks."""
    _, atol_p, atol_v = CASES[name]
    _, single, ranks = runs[name]
    st = domain.gather_state([r["states"][-1] for r in ranks])
    pos, vel = _by_id(st.particles.pos, st.particles.vel, st.particles.ids)
    spos, svel = _by_id(single.particles.pos, single.particles.vel,
                        single.particles.ids.numpy())
    np.testing.assert_allclose(pos, spos, atol=atol_p)
    np.testing.assert_allclose(vel, svel, atol=atol_v)
    b0, b1 = ranks[0]["states"][-1].bodies, ranks[-1]["states"][-1].bodies
    for f in ("pos", "rot", "linvel", "angvel"):
        assert np.array_equal(getattr(b0, f).view(np.uint32), getattr(b1, f).view(np.uint32))


def test_sparse_domain_shards_only_spatially():
    """The sparse domain's ranks hold different slot tables, so their slot
    grids cannot be summed: the port refuses particle sharding there (the
    JAX package sums them; tools/check_jax_sparse_sharding.py) and takes
    spatial slabs."""
    d = scenes.sand_box_3d(nxz=4, ny=6, device="cpu", sparse=True)
    with pytest.raises(ValueError, match="spatially"):
        domain.make_sharded_step(d.config, Comm(0, 2, "gloo"), 1)
    sp = domain.spatial_config(d.config, 2)
    domain.make_sharded_step(sp, Comm(0, 2, "gloo"), 1)
    with pytest.raises(ValueError, match="slabs"):
        domain.make_sharded_step(sp, Comm(0, 4, "gloo"), 1)


def test_nccl_needs_one_card_a_rank():
    """Two ranks on one device raise before any rank starts; gloo takes
    them (it stages through the host)."""
    with pytest.raises(ValueError, match="one card a rank"):
        launch.run(launch.step_jobs, 2, backend="nccl", devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="CUDA"):
        check_devices("nccl", ["cpu", "cpu"])
    check_devices("gloo", ["cuda:0", "cuda:0"])


def test_pad_shard_gather_round_trip():
    """pad_state's zero-mass lanes (id -1, F = I, below the grid: the
    overflow bucket, where no job takes them) and shard_state / gather_state
    give back the padded state in order."""
    from wgsparkl_tpu_torch.ops import blocked as bk

    d = scenes.sand_box_3d(nxz=3, ny=5, device="cpu", by=8)
    n = d.num_particles
    total = domain.pad_particle_count(n, 4)
    assert total % 4 == 0 and 0 < total - n < 4
    padded = domain.pad_state(d.state, d.config.grid, total)
    p = padded.particles
    assert p.count == total and (p.ids[n:] == -1).all() and (p.mass[n:] == 0).all()
    assert (p.def_grad[n:] == torch.eye(3)).all()
    keys = bk.particle_sort_keys_ch([p.pos[n:, a] for a in range(3)], d.config.grid, 8)
    assert (keys == int(np.prod(bk.num_blocks(d.config.grid, 8)))).all()
    back = domain.gather_state([domain.shard_state(padded, r, 4) for r in range(4)])
    for a, b in ((back.particles.pos, p.pos), (back.models.lam, padded.models.lam),
                 (back.models.dp["h0"], padded.models.dp["h0"])):
        assert torch.equal(a, b)
    assert back.models.mat_table is padded.models.mat_table
    with pytest.raises(ValueError, match="divide"):
        domain.shard_state(d.state, 0, 4)       # 45 particles
