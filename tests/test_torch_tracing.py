"""The frame loop's spans and counters (wgsparkl_tpu_torch/utils/tracing.py)
on small versions of the benchmark's scenes (2D: elastic_cut2's block on a
blade; 3D: heightfield3's sand over a small field; both run the mesh pass,
the dense CDF mode and the window scatter; 3D: the main path's sand in five
walls with the spinning paddle, shrunk, which runs the gathered-hybrid
mode: the frame's static hoist, the paddle's reach gate, in-kernel moving
work at gate level 2).

  * Off: nothing is recorded and no record_function runs; on without a
    profiler, none runs either; the state after a frame is bit-equal to the
    state after the same frame traced.
  * On: one `mpm.frame` a call with one `mpm.hoist` and its substeps'
    spans under it, each phase's span under its parent and inside its
    parent's times (`mpm.moving_gate` under `mpm.cdf` in the hybrid mode);
    the dense transfer's frame holds `mpm.frame` and `mpm.substep` only.
  * `jobs.live` equals the job table's live slots, `jobs.slots` its size;
    `jobs.moving` the live jobs at gate level 2 in the hybrid mode, and is
    absent in the dense mode.
  * `scatter.pull` reads 0 on each CPU substep, bounded or sparse; on the
    card 1 on each bounded substep and 0 on a sparse one (marked `cuda`),
    each `mpm.scatter` under its `mpm.substep`.
  * Under torch.profiler the spans start where their `user_annotation`
    events do (trace `ts` + `baseTimeNanoseconds / 1e3`): nine in ten within
    50 us, the median within 20 us.
  * A traced benchmark run of the small cell (mpmbench.run.run_cell on the
    CPU, one profiled frame a pass, in a process of its own:
    tests/conftest.py loads JAX, which the harness refuses) stays correct
    and reports the spans' host metrics and the live share of job slots,
    and no device-marker metric.
"""

import dataclasses
import gc
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from mpmbench import program, scene
from mpmbench.tests.bench_small import moving_files, small_files
from wgsparkl_tpu_torch.pipeline import MpmPipeline, step_pallas
from wgsparkl_tpu_torch.utils import tracing

REPO = pathlib.Path(__file__).resolve().parents[1]
CELLS = ("cut2.frame15", "hf3.frame20")
HYBRID = "paddle3"
SCENES = CELLS + (HYBRID,)
SEED = 2 ** 31 + 77
SUBSTEP_CHILDREN = {"mpm.jobs", "mpm.cdf", "mpm.p2g", "mpm.scatter", "mpm.gather_grid",
                    "mpm.g2p", "mpm.update", "mpm.rigid"}
# The CDF phase's spans: the dense mode's (mesh scenes), the hybrid mode's.
CDF_CHILDREN = {"mpm.mesh_pass", "mpm.gather_nodes"}
HYBRID_CDF_CHILDREN = {"mpm.gather_nodes", "mpm.moving_gate"}


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def _data(cell, transfer=None):
    _, cfg, traffic, _ = moving_files(cell) if cell == HYBRID else small_files(cell)
    if transfer is not None:
        cfg = dict(cfg, transfer=transfer)
    inputs = scene.make(cfg, traffic, SEED)
    return program.build(inputs, "cpu"), inputs.substeps


def _frame(data, substeps, on: bool):
    if on:
        tracing.enable()
    MpmPipeline().step(data, substeps)
    tracing.disable()


@pytest.mark.parametrize("cell", SCENES)
def test_off_records_nothing_and_leaves_the_state_alone(monkeypatch, cell):
    data, substeps = _data(cell)
    initial = program.copy_state(data.state)
    opened = []
    rf = torch.autograd.profiler.record_function
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name, *a: opened.append(name) or rf(name, *a))
    _frame(data, substeps, on=False)
    assert tracing.collect() == [] and opened == []
    with pytest.raises(KeyError):
        with tracing.span("mpm.frame"):
            raise KeyError("an off span lets exceptions through")
    off = data.state
    data.state = initial
    _frame(data, substeps, on=True)
    assert len(tracing.collect()) == 1 and opened == []
    for f in ("pos", "vel", "def_grad", "affine", "cdf_affinity", "ids"):
        assert torch.equal(getattr(off.particles, f), getattr(data.state.particles, f)), f
    for k, v in dataclasses.asdict(off.models).items():
        if torch.is_tensor(v):
            assert torch.equal(v, getattr(data.state.models, k)), k
    for f in ("pos", "rot", "linvel", "angvel"):
        assert torch.equal(getattr(off.bodies, f), getattr(data.state.bodies, f)), f


def _children(spans, parent):
    return [s for s in spans if s["parent"] == parent["id"]]


@pytest.mark.parametrize("cell", SCENES)
def test_spans_nest_under_the_frame(cell):
    data, substeps = _data(cell)
    _frame(data, substeps, on=True)
    (session,) = tracing.collect()
    spans = session["spans"]
    assert session["frames"] == 1 and session["dropped"] == 0 and not session["profiler"]
    (frame,) = [s for s in spans if s["name"] == "mpm.frame"]
    assert frame["parent"] is None and frame["frame"] == 0
    top = _children(spans, frame)
    subs = [s for s in top if s["name"] == "mpm.substep"]
    assert {s["name"] for s in top} == {"mpm.pack", "mpm.hoist", "mpm.substep",
                                        "mpm.unpack"}
    # The frame's hoist: once, before the substeps.
    (hoist,) = [s for s in spans if s["name"] == "mpm.hoist"]
    assert hoist["parent"] == frame["id"] and hoist["end_us"] <= subs[0]["start_us"]
    assert [s["substep"] for s in subs] == list(range(substeps))
    for sub in subs:
        kids = _children(spans, sub)
        assert sorted(s["name"] for s in kids) == sorted(SUBSTEP_CHILDREN)
        (cdf,) = [s for s in kids if s["name"] == "mpm.cdf"]
        assert {s["name"] for s in _children(spans, cdf)} == (
            HYBRID_CDF_CHILDREN if cell == HYBRID else CDF_CHILDREN)
    for s in spans:
        assert s["device_ms"] is None and s["host_ms"] >= s["self_ms"] >= 0
        if s["parent"] is not None:
            (p,) = [q for q in spans if q["id"] == s["parent"]]
            assert p["start_us"] <= s["start_us"] <= s["end_us"] <= p["end_us"]
            assert s["frame"] == 0
    assert abs(sum(s["host_ms"] for s in top) + frame["self_ms"] - frame["host_ms"]) < 1e-6


@pytest.mark.parametrize("cell", CELLS)
def test_dense_frame_holds_frame_and_substeps(cell):
    data, substeps = _data(cell, transfer="dense")
    _frame(data, 2, on=True)
    (session,) = tracing.collect()
    names = [s["name"] for s in session["spans"]]
    assert names == ["mpm.frame", "mpm.substep", "mpm.substep"]
    assert session["counters"] == {}


@pytest.mark.parametrize("cell", SCENES)
def test_job_counters(cell):
    data, _ = _data(cell)
    rec = {}
    tracing.enable()
    step_pallas(data.state, data.params, data.config, 1, record=rec)
    (session,) = tracing.collect()
    live, slots = session["counters"]["jobs.live"], session["counters"]["jobs.slots"]
    assert live == [int((rec["jobs"]["len"] > 0).sum())]
    assert slots == [data.config.max_jobs] == [rec["src"].shape[0]]
    assert 0 < live[0] < slots[0]
    if cell == HYBRID:
        # The live jobs at gate level 2: A and B evaluate the paddle there.
        moving = session["counters"]["jobs.moving"]
        assert moving == [int(((rec["jbody"] == 2) & (rec["jobs"]["len"] > 0)).sum())]
        assert 0 < moving[0] <= live[0]
    else:
        # The dense mode (mesh scenes) has no in-kernel moving work.
        assert "jobs.moving" not in session["counters"]


def _scatter_session(data, substeps):
    """A traced frame's session; every `mpm.scatter` under an `mpm.substep`."""
    _frame(data, substeps, on=True)
    (session,) = tracing.collect()
    spans = session["spans"]
    subs = {s["id"] for s in spans if s["name"] == "mpm.substep"}
    scatters = [s for s in spans if s["name"] == "mpm.scatter"]
    assert len(subs) == len(scatters) == substeps
    assert {s["parent"] for s in scatters} == subs
    return session, scatters


def _sparse_box(device):
    from wgsparkl_tpu_torch import scenes

    return scenes.sand_box_3d(nxz=6, ny=6, device=device, sparse=True)


@pytest.mark.parametrize("cell", SCENES + ("sparse",))
def test_scatter_pull_counter_off_the_card(cell):
    """`scatter.pull` reads 0 on each CPU substep (bounded or sparse): the
    CPU scatter adds into zeros."""
    if cell == "sparse":
        data, substeps = _sparse_box("cpu"), 2
    else:
        data, substeps = _data(cell)
    session, _ = _scatter_session(data, substeps)
    assert session["counters"]["scatter.pull"] == [0] * substeps


@pytest.mark.cuda
@pytest.mark.parametrize("cell", SCENES + ("sparse",))
def test_card_scatter_pull_counter(cell):
    """On the card a bounded substep's scatter is the pull kernel (1 each
    substep, device markers on its span); the sparse slot scatter is not
    (0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if cell == "sparse":
        data, substeps = _sparse_box("cuda"), 2
    else:
        _, cfg, traffic, _ = moving_files(cell) if cell == HYBRID else small_files(cell)
        inputs = scene.make(cfg, traffic, SEED)
        data, substeps = program.build(inputs, "cuda"), inputs.substeps
    session, scatters = _scatter_session(data, substeps)
    assert session["counters"]["scatter.pull"] == [int(cell != "sparse")] * substeps
    assert all(s["device_ms"] is not None for s in scatters)


@pytest.mark.parametrize("cell", CELLS)
def test_span_starts_match_the_profiler_trace(tmp_path, cell):
    data, substeps = _data(cell)
    _frame(data, 1, on=False)
    acts = [torch.profiler.ProfilerActivity.CPU]
    # A process's first profiler session records its first events late.
    with torch.profiler.profile(activities=acts):
        torch.ones(4).sum()
    # A collection inside record_function's entry would lag one start.
    gc.collect()
    gc.disable()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            MpmPipeline().step(data, substeps)
    finally:
        gc.enable()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace["baseTimeNanoseconds"] / 1e3
    events = {}
    for e in sorted(trace["traceEvents"], key=lambda e: float(e.get("ts", 0))):
        if e.get("cat") == "user_annotation" and e["name"].startswith(tracing.PREFIX):
            events.setdefault(e["name"], []).append(float(e["ts"]) + base_us)
    (session,) = tracing.collect()
    assert session["profiler"] and session["frames"] == 1
    starts = {}
    for s in session["spans"]:
        starts.setdefault(s["name"], []).append(s["start_us"])
    assert {k: len(v) for k, v in starts.items()} == {k: len(v) for k, v in events.items()}
    gaps = sorted(abs(a - b) for k in starts for a, b in zip(starts[k], events[k]))
    # The scheduler can stall the thread inside record_function's entry on
    # a loaded machine (2.8 ms on one span of 223 under six test workers):
    # a clock that maps wrong moves every span, the middle and the tail.
    assert gaps[len(gaps) // 2] < 20.0 and gaps[9 * len(gaps) // 10] < 50.0, gaps[-5:]


# The one test that sets its thread count itself: this script runs in an
# interpreter of its own, which loads no conftest.py (the repository's sets
# one thread for every test process, six of which share eight cores).
RUN = """
import json, sys, torch
from mpmbench import run
from mpmbench.tests.bench_small import small_files
torch.set_num_threads(1)
run.PROFILED_FRAMES = 1
cell = sys.argv[1]
res = run.run_cell(run.load_benchmark(), cell, int(sys.argv[2]), 0.5, True, device="cpu",
                   files=small_files(cell, episode=3))
print(json.dumps({"correct": res["correct"], "metrics": res["metrics"]}))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_traced_benchmark_run(cell):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", RUN, cell, str(SEED)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert res["correct"]
    assert m["pipeline.jobs_host_ms_per_substep"] > 0
    assert m["pipeline.cdf_host_ms_per_substep"] > 0
    assert 0 < m["glue.live_job_share"] < 100
    assert "glue.scatter_device_ms_per_substep" not in m
    assert "glue.gather_device_ms_per_substep" not in m
    assert "glue.hoist_device_ms_per_substep" not in m
