"""The port's joints against the JAX package on the CPU, and on their own.

`rigid_bodies_update` with tests/test_joints.py's joint scenes (pendulum,
dynamic chain, fixed, revolute, prismatic along x, y and a tilted axis)
against the JAX package's: 50 chained updates from random CPIC impulses
(torch_rigid_scenes.update_matches_jax states the tolerances).  Then the
behaviour checks of tests/test_joints.py on the port's own rigid loop (the
plain version of the rigid-solve kernel): the pendulum swings and hangs
under its pivot, the chain holds, the weld holds, the hinge swings in its
plane, the slider holds across its axis and falls along it; and the same
in 2D, where the JAX package's joints fail (its [2] per-axis dynamic mask
meets the [1] angular velocity).
"""

import pytest
import torch

import torch_rigid_scenes as R
from wgsparkl_tpu_torch.collision.shapes import Collider
from wgsparkl_tpu_torch.pipeline import RigidBodyDesc

torch.set_num_threads(1)


@pytest.mark.parametrize("name", R.JOINT_SCENES)
def test_joint_update_matches_jax(name):
    R.update_matches_jax(name)


def test_pendulum_swings_and_hangs_under_its_pivot():
    run, b, (j,) = R.rig([R.PORT_ANCHOR, RigidBodyDesc(Collider.cuboid(0.1, 1.0, 0.1),
                                               (1.0, 9.0, 0.0), body_type="dynamic")],
                        ((1, 0, (0.0, 1.0, 0.0), (0.0, 0.0, 0.0)),))
    b = run(b, 400)
    assert abs(float(b.pos[1, 0]) - 1.0) > 0.05 and R.anchor_gap(b, j) < 0.05
    b = run(b, 14 * 400)
    assert torch.isfinite(b.pos).all() and R.anchor_gap(b, j) < 0.05
    assert abs(float(b.pos[1, 0])) < 0.35 and float(b.pos[1, 1]) < 9.3


def test_revolute_joint_hinges():
    run, b, (j,) = R.rig([R.PORT_ANCHOR, RigidBodyDesc(Collider.cuboid(1.0, 0.1, 0.1),
                                               (1.0, 10.0, 0.0), body_type="dynamic")],
                        ((1, 0, (-1.0, 0.0, 0.0), (0.0, 0.0, 0.0), "revolute",
                          (0.0, 0.0, 1.0)),))
    b = run(b, 400)
    assert float(b.pos[1, 1]) < 9.9 and abs(float(b.pos[1, 2])) < 0.02
    assert float(b.rot[1, 1:3].abs().max()) < 0.05 and R.anchor_gap(b, j) < 0.05


@pytest.mark.parametrize("dim", [2, 3])
def test_prismatic_joint_slides(dim):
    def run_axis(axis):
        run, b, _ = R.rig([RigidBodyDesc(Collider.ball(0.1), (0.0, 10.0, 0.0)[:dim]),
                          RigidBodyDesc(Collider.cuboid(0.3, 0.2, 0.2)
                                        if dim == 3 else Collider.cuboid(0.3, 0.2),
                                        (0.0, 10.0, 0.0)[:dim], body_type="dynamic")],
                         ((1, 0, (0.0,) * dim, (0.0,) * dim, "prismatic", axis[:dim]),),
                         dim)
        return run(b, 400)

    across = run_axis((1.0, 0.0, 0.0))
    assert abs(float(across.pos[1, 1]) - 10.0) < 0.02
    assert float(across.rot[1, 1:].abs().max()) < 0.05
    along = run_axis((0.0, 1.0, 0.0))
    assert 0.5 < 10.0 - float(along.pos[1, 1]) < 1.1
    assert abs(float(along.pos[1, 0])) < 0.02
    assert float(along.rot[1, 1:].abs().max()) < 0.05
