"""Colliders at a pose and kinematic bodies: the reference against the
port's plain CPU path on two small scenes with a spinning body (the 3D
main path's sand, walls and paddle, shrunk; a 2D sand block on a stirrer),
body_gap among the compared numbers; the bfloat16 control and the bodies
held rejected; a whole small run sound and with the bodies held; the
cuboid kind's node CDF against the port's analytic one at a rotated pose;
the mesh kinds at a pose against the old contract and against the mesh
rotated directly; a dynamic body refused at load."""

import math

import numpy as np
import pytest
import torch

from mpmbench import calibrate, compare, program, run, scene
from mpmbench.reference import Reference
from mpmbench.reference import bodies as body_ref
from mpmbench.reference import mesh
from mpmbench.reference.mpm import Grid
from mpmbench.tests.bench_small import MOVING_LIMITS, moving_files

SCENES = ("paddle3", "stirrer2")
SEED = 2 ** 31 + 977


@pytest.fixture(scope="module")
def readings():
    """Each scene's calibration readings (program, control, faults)."""
    torch.set_num_threads(4)
    return {s: calibrate.readings(s, SEED, True, device="cpu", files=moving_files(s))
            for s in SCENES}


@pytest.mark.parametrize("name", SCENES)
def test_program_agrees_with_reference(readings, name):
    r = readings[name]
    assert r["failed"] == 0
    assert "body_gap" in MOVING_LIMITS
    assert compare.judge(r["program"], MOVING_LIMITS), r["program"]
    # The kinematic body moved on both sides: its gap is rounding, not 0.
    assert 0 < r["program"]["body_gap"] < 1e-6


@pytest.mark.parametrize("name", SCENES)
def test_control_and_held_bodies_are_rejected(readings, name):
    r = readings[name]
    assert not compare.judge(r["control"], MOVING_LIMITS), r["control"]
    assert r["control"]["body_gap"] > MOVING_LIMITS["body_gap"]
    assert not compare.judge(r["held"], MOVING_LIMITS), r["held"]
    # Held, only the bodies read wrong.
    assert {k for k, v in r["held"].items() if v > MOVING_LIMITS.get(k, math.inf)} == {
        "body_gap"}


def _held(step):
    """MpmPipeline.step with every body left as it was before the call."""
    def held(self, data, num_substeps=1, params=None):
        bodies = data.state.bodies
        diag = step(self, data, num_substeps, params)
        data.state.bodies = bodies
        return diag
    return held


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("broken", (False, True), ids=("sound", "held"))
def test_whole_run(monkeypatch, name, broken):
    """A whole small run on the CPU: correct when sound; not correct when
    the timed path leaves the kinematic body where it was."""
    from wgsparkl_tpu_torch.pipeline import MpmPipeline

    if broken:
        monkeypatch.setattr(MpmPipeline, "step", _held(MpmPipeline.step))
    torch.set_num_threads(4)
    res = run.run_cell(run.load_benchmark(), name, 2 ** 31 + 4242, 0.5, False, device="cpu",
                       files=moving_files(name, episode=3))
    assert res["correct"] is not broken, res["checks"]
    assert (res["checks"]["body_gap"]["value"] > MOVING_LIMITS["body_gap"]) is broken


@pytest.mark.parametrize("name", SCENES)
def test_cuboid_node_cdf_matches_the_port(name):
    """The cuboid kind's node CDF of every collider of the scene, the
    kinematic one at its rotated pose, merged, against the port's analytic
    node CDF at the same nodes and poses: distances, closest slot and
    affinity bits."""
    from wgsparkl_tpu_torch.collision.cdf import node_cdf

    _, cfg, traffic, _ = moving_files(name)
    inputs = scene.make(cfg, traffic, SEED)
    data = program.build(inputs, "cpu")
    b = data.state.bodies
    ref = Reference(inputs, "cpu")
    g = ref.grid
    col = ref._colliders(program.read_state(data.state)["bodies"])
    axes = [torch.arange(n) + o for o, n in zip(g.origin, g.shape)]
    nodes = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, g.dim)
    dist, aff, closest = node_cdf(data.config.collider_types, b.shape_params, b.rot, b.pos,
                                  nodes.float() * g.h, g.h)
    assert (col.closest >= 0).sum() > 0 and ((col.aff >> 16) != 0).sum() > 0
    assert torch.equal(closest.long(), col.closest)
    assert torch.equal(aff.long() & 0xFFFFFFFF, col.aff)
    near = col.closest >= 0
    assert torch.allclose(dist[near].double(), col.dist[near], rtol=0, atol=2e-6)


def _polyline():
    v = [[-2.0, 1.0], [-0.7, 0.2], [0.4, 0.5], [1.9, -0.3]]
    part = scene.load_part("colliders", "polyline")
    return scene.Collider("polyline", (0.3, -0.5), part.make({"vertices": v}, None)), (
        Grid.from_bounds([-3.0, -2.0], [3.0, 2.0], 0.2))


def _heightfield():
    spec = {"resolution": [9, 7], "scale": [6.0, 2.0, 5.0], "amplitude": 0.4, "waves": 3.0,
            "noise": 0.1}
    c = scene.load_part("colliders", "heightfield").make(spec, np.random.default_rng(5))
    return scene.Collider("heightfield", (0.2, 1.0, -0.3), c), (
        Grid.from_bounds([-4.0, -2.0, -4.0], [4.0, 4.0, 4.0], 0.5))


def _surface(c, grid):
    """The kind's samples in the body's frame: (vertices, points, primitives)."""
    scene.load_part("colliders", c.kind).node_cdf(c, (np.zeros(grid.dim), np.eye(grid.dim)),
                                                  grid, torch.float64, "cpu")
    return c.cache[grid.h]


def _old_contract(verts, points, prims, shift, grid):
    """The node CDF as the fixed-collider contract gave it: the samples
    stored at float32 and moved by the translation."""
    t = torch.as_tensor
    pts = points.astype(np.float32).astype(np.float64) + shift
    dist, _, aff = mesh.node_cdf(t(pts), t(prims), t(np.zeros(len(pts), np.int64)),
                                 t(verts + shift), 1, grid, torch.float64)
    return dist, (aff & 1) != 0, ((aff >> 16) & 1) != 0


@pytest.mark.parametrize("make", (_polyline, _heightfield), ids=("polyline", "heightfield"))
def test_mesh_kind_at_identity_is_the_old_contract(make):
    c, grid = make()
    shift = np.asarray(c.translation, np.float64)
    got = scene.load_part("colliders", c.kind).node_cdf(
        c, (shift, np.eye(grid.dim)), grid, torch.float64, "cpu")
    want = _old_contract(*_surface(c, grid), shift, grid)
    assert bool(want[1].any())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("make", (_polyline, _heightfield), ids=("polyline", "heightfield"))
def test_mesh_kind_at_a_pose_is_the_mesh_rotated(make):
    """Samples taken in the body's frame and placed by the pose give the
    node CDF of the mesh rotated and moved first, then sampled."""
    c, grid = make()
    d = grid.dim
    rotation = 0.7 if d == 2 else [0.3, -0.8, 0.5]
    r = body_ref.rotation_matrix(torch.tensor([body_ref.quaternion(d, rotation)],
                                              dtype=torch.float64))[0].numpy()
    shift = np.asarray(c.translation, np.float64)
    got = scene.load_part("colliders", c.kind).node_cdf(c, (shift, r), grid, torch.float64,
                                                         "cpu")
    verts, _, _ = _surface(c, grid)
    moved = verts @ r.T + shift
    if d == 2:
        k = np.arange(len(moved) - 1)
        points, prims = mesh.sample_polylines(moved, np.stack([k, k + 1], -1), grid.h)
    else:
        _, tri = mesh.heightfield_trimesh(c.data["heights"], c.data["scale"])
        points, prims = mesh.sample_trimesh(moved, tri, grid.h)
    want = _old_contract(moved, points, prims, np.zeros(d), grid)
    assert bool(want[1].any()) and not bool(torch.equal(got[1], _old_contract(
        *_surface(c, grid), shift, grid)[1]))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    reach = want[1]
    assert torch.allclose(got[0][reach], want[0][reach], rtol=0, atol=1e-12)


@pytest.mark.parametrize("entry, match", [
    ({"body_type": "dynamic"}, "rigid solve"),
    ({"body_type": "fixed", "angvel": [0.0, 1.0, 0.0]}, "no velocity"),
    ({"body_type": "floating"}, "not one of"),
])
def test_unsupported_bodies_are_refused_at_load(entry, match):
    _, cfg, traffic, _ = moving_files("paddle3")
    cfg["colliders"][-1] = {**cfg["colliders"][-1], "angvel": None, **entry}
    with pytest.raises(ValueError, match=match):
        scene.make(cfg, traffic, 1)
