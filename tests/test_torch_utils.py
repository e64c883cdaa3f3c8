"""The port's utils against the JAX package's: checkpoints (the npz format,
the leaf names, a round trip bit for bit, files of either package loaded
by the other, the errors), diagnostics.check (equal to JAX's at by 4 on
tests/test_parallel.py's and tests/test_sparse_domain.py's scenes; at by 8
the job demand of the scene's own job table), time_passes (JAX's pass
names), profile_step, profile_trace and warmup.

The reports' integers must be equal; max_speed and max_def_grad are
reductions of the same f32 values, within 1e-6 relative (numpy and torch
may round a norm's sum differently)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgsparkl_tpu import scenes as jscenes
from wgsparkl_tpu.pipeline import MpmData as JData
from wgsparkl_tpu.utils import checkpoint as jckpt
from wgsparkl_tpu.utils import diagnostics as jdiag
from wgsparkl_tpu.utils import timing as jtiming
from wgsparkl_tpu_torch import interop, scenes
from wgsparkl_tpu_torch.examples import dam_break3
from wgsparkl_tpu_torch.pipeline import MpmData, step, step_pallas
from wgsparkl_tpu_torch.utils import checkpoint, diagnostics, profiling, timing, warmup
from test_torch_examples import jax_example
from torch_port_helpers import port_bodies


def _port(jdata, **kw):
    """The port's MpmData of a JAX scene, on its grid, with `kw` (transfer,
    group, ...) as the JAX scene was built with."""
    st = interop.state_from_reference(jdata.state, "cpu")
    models = dataclasses.replace(st.models, mat_id=None, mat_table=None)
    return MpmData(interop.params_from_reference(jdata.params, "cpu"), st.particles,
                   models, port_bodies(jdata.bodies_desc), jdata.config.grid.cell_width,
                   grid=interop.config_from_reference(jdata.config).grid, **kw)


def _leaves_equal(a, b):
    la, lb = checkpoint.named_leaves(a), checkpoint.named_leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), name


# ------------------------------------------------------------------ checkpoint
def test_checkpoint_round_trip_bit_for_bit(tmp_path):
    data = scenes.sand_box_3d(nxz=4, ny=8, device="cpu", by=8, group=256)
    state = step(data.state, data.params, data.config, 2)
    state.particles.cdf_affinity[:5] = torch.tensor([-1, -2 ** 31, 65536, 7, 0],
                                                    dtype=torch.int32)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, state, extra={"frame": 7, "substeps": 20})
    loaded, extra = checkpoint.load(path, data.state)
    assert extra == {"frame": 7, "substeps": 20}
    _leaves_equal(loaded, state)
    with np.load(path) as f:
        names = json.loads(str(f["__names__"]))
        assert f["leaf_10"].dtype == np.uint32 and names[10] == ".particles.cdf_affinity"
    # The names are the JAX package's, leaf for leaf, for the same scene.
    jdata = jscenes.sand_box_3d(nxz=4, ny=8, transfer="pallas", by=8, group=256)
    jnames, _, _ = jckpt._flatten_with_names(jdata.state)
    assert names == jnames
    # Resume: a frame from the loaded state equals one from the saved state.
    a = step(state, data.params, data.config, 2)
    b = step(loaded, data.params, data.config, 2)
    _leaves_equal(a, b)


def test_checkpoints_cross_packages(tmp_path):
    """A file the JAX package wrote loads into the port for every leaf (the
    affinity word from its uint32 bits), and the port's into the JAX
    package."""
    jdata = jscenes.sand_box_3d(nxz=4, ny=8, transfer="pallas", by=8, group=256)
    rng = np.random.default_rng(3)
    p = jdata.state.particles
    jstate = jdata.state.replace(particles=p.replace(
        pos=p.pos + jnp.asarray(rng.uniform(-0.1, 0.1, p.pos.shape), jnp.float32),
        cdf_affinity=jnp.asarray(rng.integers(0, 2 ** 32, p.count, dtype=np.uint64)
                                 .astype(np.uint32))))
    jpath = str(tmp_path / "jax.npz")
    jckpt.save(jpath, jstate, extra={"frame": 3})
    tdata = _port(jdata, transfer="pallas", by=8, group=256)
    loaded, extra = checkpoint.load(jpath, tdata.state)
    assert extra == {"frame": 3}
    jnames, jarrays, _ = jckpt._flatten_with_names(jstate)
    tleaves = checkpoint.named_leaves(loaded)
    assert [n for n, _ in tleaves] == jnames
    for (name, t), a in zip(tleaves, jarrays):
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        np.testing.assert_array_equal(t.numpy(), a, err_msg=name)
    tpath = str(tmp_path / "port.npz")
    checkpoint.save(tpath, loaded, extra={"frame": 4})
    back, extra = jckpt.load(tpath, jstate)
    assert extra == {"frame": 4}
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_checkpoint_load_raises_like_jax(tmp_path):
    data = scenes.sand_box_3d(nxz=4, ny=8, device="cpu")
    no_table = dataclasses.replace(
        data.state, models=dataclasses.replace(data.state.models, mat_id=None,
                                               mat_table=None))
    path = str(tmp_path / "a.npz")
    checkpoint.save(path, no_table)
    with pytest.raises(KeyError, match="checkpoint missing leaf .models.mat_id"):
        checkpoint.load(path, data.state)
    other = scenes.sand_box_3d(nxz=4, ny=6, device="cpu")
    checkpoint.save(path, other.state)
    with pytest.raises(ValueError, match="shape mismatch for .particles.pos"):
        checkpoint.load(path, data.state)


# ----------------------------------------------------------------- diagnostics
def _same_report(t, j):
    td, jd = dataclasses.asdict(t), dataclasses.asdict(j)
    for k in ("max_speed", "max_def_grad"):
        np.testing.assert_allclose(td.pop(k), jd.pop(k), rtol=1e-6)
    assert td == jd
    assert (t.ok, t.job_overflow, t.sparse_overflow) == (j.ok, j.job_overflow,
                                                         j.sparse_overflow)
    assert t.summary().split(":")[0] == j.summary().split(":")[0]


def _moved(jdata, seed):
    """The JAX scene with velocities and F made from a numpy seed (so that
    max_speed and max_def_grad are not trivial) and one particle out of the
    grid."""
    rng = np.random.default_rng(seed)
    p = jdata.state.particles
    pos = np.asarray(p.pos).copy()
    pos[0] = -1.0e4
    return jdata.state.replace(particles=p.replace(
        pos=jnp.asarray(pos),
        vel=jnp.asarray(rng.uniform(-3, 3, p.vel.shape), jnp.float32),
        def_grad=jnp.asarray(np.eye(3) + 0.1 * rng.standard_normal(p.def_grad.shape),
                             jnp.float32)))


@pytest.mark.parametrize("scene", ["dense", "blocked_overflow", "pallas_by4",
                                   "sparse_overflow", "sparse"])
def test_check_equals_jax_at_by4(scene):
    """tests/test_parallel.py:98's scenes (the dense sand box, the blocked
    one at max_jobs 1) and tests/test_sparse_domain.py:175's (the 8 x 16
    sand box sparse at kmax 8 / amax 16 and at the defaults), and the same
    box bounded on the pallas path at by 4."""
    if scene in ("dense", "blocked_overflow"):
        base = jscenes.sand_box_3d(nxz=4, ny=8, cell_width=1.0)
        kw = ({} if scene == "dense" else
              dict(transfer="blocked", group=64, max_jobs=1, job_chunk=1))
    else:
        base = jscenes.sand_box_3d(nxz=8, ny=16, cell_width=1.0)
        kw = dict(transfer="pallas", group=64, job_chunk=8)
        if scene != "pallas_by4":
            kw.update(sparse=True)
        if scene == "sparse_overflow":
            kw.update(kmax=8, amax=16)
    jdata = JData(base.params, base.state.particles, base.state.models,
                  base.bodies_desc, 1.0, grid=base.config.grid,
                  **({"transfer": "dense"} | kw))
    tdata = _port(jdata, **({"transfer": "dense"} | kw))
    assert dataclasses.replace(tdata.config, n_materials=jdata.config.n_materials) \
        == interop.config_from_reference(jdata.config)
    _same_report(diagnostics.check(tdata), jdiag.check(jdata))
    jdata.state = _moved(jdata, 11)
    tdata.state = interop.state_from_reference(jdata.state, "cpu")
    rep = diagnostics.check(tdata)
    _same_report(rep, jdiag.check(jdata))
    assert rep.out_of_grid == 1 and rep.max_speed > 1.0
    if scene.endswith("overflow"):
        assert not rep.ok and "OVERFLOW" in rep.summary()
    if scene == "pallas_by4":
        assert rep.jobs_needed > 0


def test_check_counts_jobs_at_the_scenes_blocks(monkeypatch):
    """The dam break at SCALE 0.25 (2,216 particles, by 8, group 1024): the
    port counts the job demand of the scene's own job table; the JAX
    package counts at 4^3 blocks and reports more jobs (the port's check at
    by 4 gives JAX's count)."""
    for var in ("TRANSFER", "GROUP", "BY"):
        monkeypatch.delenv(var, raising=False)
    data = dam_break3.build(0.25, "cpu")
    assert data.num_particles == 2216 and data.config.by == 8
    rep = diagnostics.check(data)
    rec = {}
    step_pallas(data.state, data.params, data.config, 1, record=rec)
    live_jobs = int((rec["jobs"]["len"] > 0).sum())
    assert rep.jobs_needed == live_jobs == 22
    at4 = diagnostics.check(type("D", (), {
        "state": data.state, "config": dataclasses.replace(data.config, by=4)}))
    assert at4.jobs_needed == 31 > rep.jobs_needed
    jdata, _ = jax_example("dam_break3", 0.25)
    assert (jdata.config.by, jdata.config.group) == (8, 1024)
    assert jdiag.check(jdata).jobs_needed == 31


# --------------------------------------------------------- timing, profiling
@pytest.mark.parametrize("colliders", [True, False])
def test_time_passes_names_equal_jax(colliders):
    kw = {} if colliders else dict(with_paddle=False)
    jdata = jscenes.sand_box_3d(nxz=4, ny=8, **kw)
    if not colliders:
        jdata = JData(jdata.params, jdata.state.particles, jdata.state.models, [],
                      1.0, grid=jdata.config.grid)
    tdata = _port(jdata, transfer="pallas", group=256)
    jt = jtiming.time_passes(jdata.state, jdata.params, jdata.config, iters=1)
    tt = timing.time_passes(tdata.state, tdata.params, tdata.config, iters=1)
    assert list(tt.passes) == list(jt.passes)
    assert all(np.isfinite(v) and v > 0 for v in tt.passes.values())
    assert "TOTAL" in tt.report() and tt.total() > 0


def test_profile_step_rows_and_trace(tmp_path):
    data = scenes.sand_box_3d(nxz=4, ny=8, device="cpu", by=8, group=256)
    stats = {}
    rows = profiling.profile_step(data, num_substeps=1, top=12, stats=stats)
    assert 0 < len(rows) <= 12 and stats["wall_ms"] > 0
    for total, per, op, src, code in rows:
        assert total == per > 0 and isinstance(op, str)
        assert isinstance(src, str) and isinstance(code, str)
    assert [r[0] for r in rows] == sorted((r[0] for r in rows), reverse=True)
    assert any(src.endswith(".py:" + src.split(":")[-1]) and code.startswith("def ")
               for _, _, _, src, code in rows)
    profiling.print_table(rows, 0.0)
    path = timing.profile_trace(lambda s: step(s, data.params, data.config, 1),
                                (data.state,), str(tmp_path / "trace"))
    with open(path) as f:
        assert json.load(f)["traceEvents"]


def test_warmup_returns_its_seconds(capsys):
    """warmup prints its JSON record and writes no file (the JAX tool
    appends to BENCH_HISTORY.jsonl, which stays the JAX package's)."""
    history = os.path.join(os.path.dirname(__file__), os.pardir, "BENCH_HISTORY.jsonl")
    before = open(history, "rb").read()
    secs = warmup.warmup(600, 1, 256, device="cpu")
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert secs > 0 and rec["kind"] == "warmup" and rec["finite"]
    assert rec["diag"] == "OK" and rec["device"] == "cpu"
    assert abs(rec["particles"] - 600) < 100
    warmup.main(["--particles", "300", "--substeps", "1", "--group", "128", "--cpu"])
    assert json.loads(capsys.readouterr().out.strip())["particles"] > 0
    assert open(history, "rb").read() == before
