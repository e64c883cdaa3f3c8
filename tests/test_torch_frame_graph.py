"""Frame graphs (wgsparkl_tpu_torch/pipeline.py `_frame_graph`): the kernel
path's substep loop captured once per configuration and shape as a CUDA
graph, and replayed on every later call with the key.

  * CPU (tier 1): which frames run eagerly and why (`frame_graph_reason`,
    counted by `frame_graph_stats`); and the graph cache with a stand-in for
    the CUDA capture (`pipeline._record`) whose replay runs the loop on the
    graph's own input tensors and writes its results into the graph's own
    output tensors, as a replay does (the host issues no launch):
    replayed frames equal eager ones bit for bit, also after a restore
    from fresh copies; a frame's returned state survives the next frame; a
    new particle count or substep count captures anew; a capture that
    raises leaves its key eager, counted; the cache keeps its newest keys;
    plain versions bound in the kernels' place (chip_smoke.plain_versions)
    get graphs of their own; a replay's launches are counted apart from
    the host's.  On small versions of the benchmark's two scenes
    (mpmbench/tests/bench_small.py), and on a shrunk main-path paddle scene,
    whose frame hoists its fixed walls inside the replay: a replay follows
    the walls' poses it is given.
  * Card (marked `cuda`; skip without one; run them on a GPU host with
    `python -m pytest --noconftest tests/test_torch_frame_graph.py`): the
    same with real graphs on the two small scenes; under the tracer the frame
    runs eagerly with every span; the window scatter's pull kernel gives, on
    the small scenes and the shrunk paddle scene, replayed or eager, the
    frames of an accumulating scatter into zeros; and on a scene of each kind of the kernel
    path (body contacts, a joint, the sparse domain, a kinematic paddle in
    the gathered hybrid, the 2D chan-free column, no collider, and the
    one-substep entry) a replay equals an eager frame, and a replayed
    frame's launches, the host's and the replay's, are what CUPTI records
    (chip_smoke.replay_traced).
"""

import dataclasses
import warnings

import pytest
import torch

from mpmbench import program, scene
from mpmbench.tests.bench_small import moving_files, small_files
from wgsparkl_tpu_torch import pipeline
from wgsparkl_tpu_torch.ops import blocked as bk
from wgsparkl_tpu_torch.pipeline import MpmPipeline, SimState, step_pallas
from wgsparkl_tpu_torch.utils import tracing

CELLS = ("cut2.frame15", "hf3.frame20")
SEED = 2 ** 31 + 4021
FRAMES = 4
CPU_SUBSTEPS = 3    # a CPU frame's substeps (the cells': 15 and 20)
SPANS = {tracing.FRAME, tracing.SUBSTEP, "mpm.pack", "mpm.hoist", "mpm.unpack", "mpm.jobs",
         "mpm.cdf", "mpm.mesh_pass", "mpm.gather_nodes", "mpm.p2g", "mpm.scatter",
         "mpm.gather_grid", "mpm.g2p", "mpm.update", "mpm.rigid"}


@pytest.fixture(autouse=True)
def no_graphs():
    tracing.disable()
    pipeline._graphs.clear()
    yield
    tracing.disable()
    tracing.clear()
    pipeline._graphs.clear()


def _wrappers():
    import wgsparkl_tpu_torch as wt

    return [w for w in wt.kernel_wrappers().values() if hasattr(w, "launches")]


class _Replay:
    """A CUDA graph's stand-in on the CPU: replay() runs the loop on the
    tensors it captured and writes the results into its outputs; the
    host's launch counts stay as they were."""

    def __init__(self, loop, static, out):
        self.loop, self.static, self.out = loop, static, out

    def replay(self):
        host = [(w, w.launches) for w in _wrappers()]
        for o, x in zip(pipeline._leaves(self.out),
                        pipeline._leaves(self.loop(*self.static))):
            o.copy_(x)
        for w, n in host:
            w.launches = n


def _fake_record(loop, static, dev):
    out = loop(*static)
    return _Replay(loop, static, out), out


@pytest.fixture
def fake_graphs(monkeypatch):
    """Frames without a record replay through _Replay on the CPU."""
    monkeypatch.setattr(pipeline, "frame_graph_reason",
                        lambda device, record=None, comm=None:
                        None if record is None else "record")
    monkeypatch.setattr(pipeline, "_record", _fake_record)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _data(cell, device):
    """The small cell's scene on device and its substeps a frame (on the
    CPU, CPU_SUBSTEPS)."""
    _, cfg, traffic, _ = moving_files(cell) if cell == "paddle3" else small_files(cell)
    torch.set_num_threads(4)
    inputs = scene.make(cfg, traffic, SEED)
    return (program.build(inputs, device),
            inputs.substeps if device != "cpu" else CPU_SUBSTEPS)


def _frame(data, state, substeps):
    return step_pallas(state, data.params, data.config, substeps, return_diag=True)


def _eager(data, state, substeps):
    """The same frame run eagerly (a record keeps it off the graph path)."""
    return step_pallas(state, data.params, data.config, substeps, return_diag=True,
                       record={})


def _same(a, b):
    la, lb = pipeline._leaves(a), pipeline._leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and torch.equal(x, y)


def _delta(before):
    now = pipeline.frame_graph_stats()
    return {k: v - before[k] for k, v in now.items() if v != before[k]}


def _replays_equal_eager(data, substeps):
    """FRAMES frames replayed against as many eager ones, each frame's
    result checked again after the next frame, then a frame from fresh
    copies of the first state."""
    before = pipeline.frame_graph_stats()
    initial = program.copy_state(data.state)
    g = e = data.state
    kept = []
    for _ in range(FRAMES):
        g, gd = _frame(data, g, substeps)
        e, ed = _eager(data, e, substeps)
        _same((g, gd), (e, ed))
        kept.append(((g, gd), (program.copy_state(g), program.copy_state(gd))))
    for got, copy in kept:
        _same(got, copy)
    assert _delta(before) == {"captures": 1, "replays": FRAMES - 1, "record": FRAMES}
    g, gd = _frame(data, program.copy_state(initial), substeps)
    _same((g, gd), _eager(data, initial, substeps))
    assert pipeline.frame_graph_stats()["replays"] - before["replays"] == FRAMES


def _fewer(state: SimState, m: int) -> SimState:
    """The state of its first m particles."""
    particles, models = bk._tree_map(lambda x: x[:m], (state.particles, state.models))
    return dataclasses.replace(state, particles=particles, models=models)


def _new_shapes_capture(data, substeps):
    state, _ = _frame(data, data.state, substeps)
    _frame(data, state, substeps)
    before = pipeline.frame_graph_stats()
    for st, s in ((state, substeps - 1), (_fewer(state, state.particles.count - 40),
                                          substeps)):
        for _ in range(2):
            _same(_frame(data, st, s), _eager(data, st, s))
    assert _delta(before) == {"captures": 2, "replays": 2, "record": 4}


@pytest.mark.parametrize("cell", CELLS + ("paddle3",))
def test_replays_equal_eager_frames(fake_graphs, cell):
    _replays_equal_eager(*_data(cell, "cpu"))


def test_replay_hoists_the_walls_it_is_given(fake_graphs):
    """The static hoist is part of the replay: the graph copies in no
    channel grid, and a frame whose fixed walls stand elsewhere replays
    their node CDF from the poses it is given, as the eager frame does,
    and differs from the frame at the old poses."""
    data, substeps = _data("paddle3", "cpu")
    assert data.config.static_slots
    _frame(data, data.state, substeps)
    chan, _ = pipeline._hoist(data.state.bodies, data.config)
    (entry,) = pipeline._graphs.values()
    assert not [t for t in entry.inputs if t.shape == chan.shape]
    bodies = data.state.bodies
    pos = bodies.pos.clone()
    pos[list(data.config.static_slots), 1] += 0.5       # every fixed body up half a cell
    moved = dataclasses.replace(data.state, bodies=dataclasses.replace(bodies, pos=pos))
    before = pipeline.frame_graph_stats()
    got = _frame(data, moved, substeps)
    _same(got, _eager(data, moved, substeps))
    assert _delta(before) == {"replays": 1, "record": 1}
    assert not torch.equal(got[0].particles.pos,
                           _frame(data, data.state, substeps)[0].particles.pos)


@pytest.mark.parametrize("cell", CELLS)
def test_new_particle_or_substep_count_captures_anew(fake_graphs, cell):
    _new_shapes_capture(*_data(cell, "cpu"))


@pytest.mark.parametrize("cell", CELLS)
def test_failed_capture_runs_eagerly_and_counts(fake_graphs, monkeypatch, cell):
    def refuse(loop, static, dev):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(pipeline, "_record", refuse)
    data, substeps = _data(cell, "cpu")
    before = pipeline.frame_graph_stats()
    g = e = data.state
    with pytest.warns(RuntimeWarning, match="frame graph capture failed"):
        g, gd = _frame(data, g, substeps)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(2):
            e, ed = _eager(data, e, substeps)
            _same((g, gd), (e, ed))
            g, gd = _frame(data, g, substeps)
    assert not [w for w in caught if "frame graph" in str(w.message)]
    assert _delta(before) == {"capture_failed": 3, "record": 2}


def test_cache_keeps_the_newest_keys(fake_graphs):
    data, _ = _data("cut2.frame15", "cpu")
    keep = pipeline._GRAPH_CACHE
    before = pipeline.frame_graph_stats()
    for s in range(1, keep + 2):
        _frame(data, data.state, s)
    assert len(pipeline._graphs) == keep
    assert [k[1] for k in pipeline._graphs] == list(range(2, keep + 2))
    _frame(data, data.state, 2)
    _frame(data, data.state, 1)
    assert [k[1] for k in pipeline._graphs][-2:] == [2, 1]
    assert _delta(before) == {"captures": keep + 2, "replays": 1}


def test_plain_versions_bound_capture_their_own_graph(fake_graphs):
    """A frame run with plain versions bound in the kernels' place
    (chip_smoke.plain_versions, which drops the frame graphs on both sides
    of its block) captures a graph of the plain versions, which replays in
    the block; once the kernels are bound again a frame captures theirs
    anew."""
    import chip_smoke
    from wgsparkl_tpu_torch.ops import compact, permute

    data, substeps = _data("hf3.frame20", "cpu")
    _frame(data, data.state, substeps)
    _frame(data, data.state, substeps)
    before = pipeline.frame_graph_stats()
    with chip_smoke.plain_versions():
        assert not pipeline._graphs
        assert pipeline.permute_lanes is permute.permute_plain
        assert compact.compact_flagged is compact.compact_plain
        for _ in range(2):
            _same(_frame(data, data.state, substeps), _eager(data, data.state, substeps))
        assert len(pipeline._graphs) == 1
    assert not pipeline._graphs
    assert pipeline.permute_lanes is permute.permute_lanes
    _frame(data, data.state, substeps)
    assert _delta(before) == {"captures": 2, "replays": 1, "record": 2}


def test_replays_count_launches_apart_from_the_host(fake_graphs, monkeypatch):
    """The wrappers count the launches the host issues: an eager frame's,
    not the capture's (which runs nothing) nor a replay's.  Each replay
    adds its capture's launches to replayed_launch_counts;
    reset_launch_counts clears both."""
    import wgsparkl_tpu_torch as wt
    from wgsparkl_tpu_torch.ops import permute

    real = pipeline.permute_lanes

    def counted(*a, **k):
        permute.permute_lanes.launches += 1
        return real(*a, **k)

    monkeypatch.setattr(pipeline, "permute_lanes", counted)
    data, substeps = _data("cut2.frame15", "cpu")
    wt.reset_launch_counts()
    state = data.state
    for _ in range(3):
        state, _ = _frame(data, state, substeps)
    assert wt.launch_counts()["permute"] == substeps
    assert wt.replayed_launch_counts()["permute"] == 2 * substeps
    assert not [k for k, v in wt.replayed_launch_counts().items() if v and k != "permute"]
    wt.reset_launch_counts()
    assert not any(wt.launch_counts().values())
    assert not any(wt.replayed_launch_counts().values())


def _body_contacts():
    """A dynamic plate on the floor of a small sand box: the rigid update
    resolves its contacts (cfg.dynamic_slots)."""
    from wgsparkl_tpu_torch import scenes
    from wgsparkl_tpu_torch.collision.shapes import Collider
    from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc

    d = scenes.sand_box_3d(nxz=4, ny=4, device="cpu", with_paddle=False)
    plate = RigidBodyDesc(Collider.cuboid(1.0, 0.25, 1.0), (0.0, 0.2, 0.0),
                          body_type="dynamic")
    return MpmData(d.params, d.state.particles, d.state.models,
                   list(d.bodies_desc) + [plate], 1.0, grid=d.config.grid)


@pytest.mark.parametrize("case", ["cpu", "record", "comm", "tracer", "profiler",
                                  "body_contacts"])
def test_eager_reason(case):
    """Off the card every frame is eager ("cpu"); on it a record, a comm,
    the tracer or a profiler keep it eager; a body-contact configuration
    replays (its one host read, of the contact depths, is in the rigid
    solve's plain version, which runs on CPU tensors only)."""
    want = {"profiler": "tracer", "body_contacts": None}.get(case, case)
    kw = {"record": {"record": {}}, "comm": {"comm": object()}}.get(case, {})
    device = torch.device("cpu" if case == "cpu" else "cuda")
    if case == "tracer":
        tracing.enable()
    if case == "profiler":
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            got = pipeline.frame_graph_reason(device, **kw)
    else:
        got = pipeline.frame_graph_reason(device, **kw)
    assert got == want
    if case == "body_contacts":
        data = _body_contacts()
        assert data.config.dynamic_slots
        before = pipeline.frame_graph_stats()
        step_pallas(data.state, data.params, data.config, 2)
        assert _delta(before) == {"cpu": 1}


@pytest.mark.parametrize("cell", CELLS)
def test_cpu_frames_run_eagerly(cell):
    data, substeps = _data(cell, "cpu")
    before = pipeline.frame_graph_stats()
    state, diag = _frame(data, data.state, substeps)
    _same((state, diag), _eager(data, data.state, substeps))
    assert _delta(before) == {"cpu": 2}
    assert not pipeline._graphs


# ---------------------------------------------------------------- the card


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_card_replays_equal_eager_frames(cell):
    _replays_equal_eager(*_data(cell, _card()))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_card_new_particle_or_substep_count_captures_anew(cell):
    _new_shapes_capture(*_data(cell, _card()))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_card_tracer_runs_eagerly_with_every_span(cell):
    data, substeps = _data(cell, _card())
    state, _ = _frame(data, data.state, substeps)
    before = pipeline.frame_graph_stats()
    tracing.enable()
    MpmPipeline().step(data, substeps)
    tracing.disable()
    assert _delta(before) == {"tracer": 1}
    names = {s["name"] for s in tracing.collect()[-1]["spans"]}
    assert names == SPANS
    _same(_frame(data, state, substeps), _eager(data, state, substeps))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS + ("paddle3",))
def test_card_pull_frames_equal_add_rows_frames(monkeypatch, cell):
    """The window scatter's pull kernel, replayed and eager, gives the
    frames that adding every job slot into a zeroed grid (add_rows, an
    accumulating index_put_) gives, bit for bit."""
    import wgsparkl_tpu_torch as wt

    data, substeps = _data(cell, _card())
    wt.reset_launch_counts()
    g = e = data.state
    for _ in range(FRAMES):
        g, gd = _frame(data, g, substeps)
        e, ed = _eager(data, e, substeps)
    pulls = wt.launch_counts()["scatter_pull"] + wt.replayed_launch_counts()["scatter_pull"]
    assert pulls == 2 * FRAMES * substeps
    def add_rows_into_zeros(grid, tiles, block, cum, nb, by):
        return bk.scatter_tiles(grid.zero_(), tiles, bk.window_sources(block, nb, by))

    monkeypatch.setattr(bk, "scatter_tiles_pull", add_rows_into_zeros)
    a = data.state
    for _ in range(FRAMES):
        a, ad = _eager(data, a, substeps)
    _same((g, gd), (a, ad))
    _same((e, ed), (a, ad))


def _kinds():
    import chip_smoke
    from wgsparkl_tpu_torch import scenes

    return {
        "sand2_pressed": lambda: chip_smoke.sand2_scene(
            "cuda", chip_smoke.SAND2_SMALL, plates=chip_smoke.sand2_pressed(48),
            shift=(0.0, -4.55), group=128),
        "plate_joint_3d": lambda: chip_smoke.plate_joint_3d("cuda"),
        "sparse_ramp": lambda: chip_smoke.ramp_scene("cuda", sparse=True),
        "sparse_overflow": lambda: scenes.sand_box_3d(
            nxz=8, ny=16, device="cuda", group=64, sparse=True, kmax=8, amax=16),
        "paddle_3d": lambda: chip_smoke.scenes_small_3d("cuda", (0.0, -3.0, 0.0)),
        "chan_free_2d": lambda: chip_smoke.stirred_column_2d("cuda", chan_free=True),
        "collider_free_3d": lambda: chip_smoke.collider_free(
            chip_smoke.scenes_small_3d("cuda"), jitter=0.1, by=8, group=256),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sand2_pressed", "plate_joint_3d", "sparse_ramp",
                                  "sparse_overflow", "paddle_3d", "chan_free_2d",
                                  "collider_free_3d", "substep_pallas"])
def test_card_every_kind_replays_equal_eager(kind):
    import chip_smoke
    import wgsparkl_tpu_torch as wt

    _card()
    data = _kinds().get(kind, _kinds()["paddle_3d"])()
    cfg = data.config
    if kind == "substep_pallas":
        def frame(state, eager=False):
            if eager:
                return pipeline._frame_pallas(state, data.params, cfg, 1, {}, None,
                                              False)[0]
            return pipeline.substep_pallas(state, data.params, cfg)
    else:
        def frame(state, eager=False):
            return step_pallas(state, data.params, cfg, 3, return_diag=True,
                               record={} if eager else None)
    def state_of(out):
        return out[0] if isinstance(out, tuple) else out

    before = pipeline.frame_graph_stats()
    g = e = data.state
    for i in range(3):
        g = frame(state_of(g))
        e = frame(state_of(e), eager=True)
        torch.cuda.synchronize()
        _same(g, e)
    assert _delta(before) == {"captures": 1, "replays": 2, "record": 3}
    problems, _ = chip_smoke.replay_traced(wt, lambda st: state_of(frame(st)), state_of(g),
                                           kind)
    assert not problems
