"""The reference against the port's plain CPU path on small versions of
both cells, its own surface sampling against the port's, and the control:
the reference in bfloat16 in the program's place fails the limits."""

import numpy as np
import pytest
import torch

from mpmbench import calibrate, compare
from mpmbench.reference import mesh
from mpmbench.tests.bench_small import small_files

CELLS = ("cut2.frame15", "hf3.frame20")
SEED = 2 ** 31 + 977


@pytest.fixture(scope="module")
def readings():
    """Each small cell's calibration readings (program, control, faults)."""
    torch.set_num_threads(4)
    return {w: calibrate.readings(w, SEED, True, device="cpu", files=small_files(w))
            for w in CELLS}


@pytest.mark.parametrize("workload", CELLS)
def test_program_agrees_with_reference(readings, workload):
    r = readings[workload]
    limits = small_files(workload)[3]
    assert r["failed"] == 0
    assert compare.judge(r["program"], limits), r["program"]


@pytest.mark.parametrize("workload", CELLS)
def test_lower_precision_is_rejected(readings, workload):
    r = readings[workload]
    limits = small_files(workload)[3]
    assert not compare.judge(r["control"], limits), r["control"]
    # It fails by the frame numbers, not by the start alone.
    assert any(r["control"][k] > limits[k] for k in ("pos_gap", "vel_gap", "F_gap"))


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ("unchanged", "half", "altered"))
def test_planted_faults_are_rejected(readings, workload, fault):
    assert not compare.judge(readings[workload][fault], small_files(workload)[3])


def test_sampling_matches_the_port():
    """The reference's samples of a heightfield and a polyline are the
    port's as sets of (point, primitive)."""
    from wgsparkl_tpu_torch.rigid import sampling

    heights = np.random.default_rng(5).standard_normal((9, 7)) * 0.3
    v, tri = mesh.heightfield_trimesh(heights, (6.0, 2.0, 5.0))
    pv, ptri = sampling.heightfield_to_trimesh(heights, (6.0, 2.0, 5.0))
    assert np.array_equal(tri, ptri) and np.allclose(v, pv)
    v32 = v.astype(np.float32).astype(np.float64)
    ours = mesh.sample_trimesh(v32, tri, 0.5)
    theirs = sampling.sample_trimesh(v32.astype(np.float32), tri, 0.5, use_native=False)
    pts = lambda p, pr: {tuple(np.round(np.r_[a, b], 5))  # noqa: E731
                         for a, b in zip(p.astype(np.float32).astype(np.float64), pr)}
    assert pts(*ours) == pts(theirs.points, theirs.primitives)
    line = np.array([[0.0, 0.0], [1.3, 0.4], [2.0, -0.7]])
    seg = np.array([[0, 1], [1, 2]])
    ours = mesh.sample_polylines(line, seg, 0.2)
    theirs = sampling.sample_polyline(line, seg, 0.2)
    assert pts(*ours) == pts(theirs.points, theirs.primitives)
