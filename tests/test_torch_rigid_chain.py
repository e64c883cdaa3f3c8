"""Behaviour of the port's joints on its own rigid loop (the plain version
of the rigid-solve kernel), as tests/test_joints.py checks the JAX
package's: a chain of two dynamic links hangs from a fixed anchor and both
joints hold; a weld holds its relative pose against gravity; 2D links swing
on a ball joint and hold a weld (the JAX package fails on every 2D joint:
its [2] per-axis dynamic mask meets the [1] angular velocity)."""

import torch

import torch_rigid_scenes as R
from wgsparkl_tpu_torch.collision.shapes import Collider
from wgsparkl_tpu_torch.math import pose
from wgsparkl_tpu_torch.pipeline import RigidBodyDesc


def test_dynamic_chain_stays_connected():
    run, b, joints = R.rig([R.PORT_ANCHOR,
                           RigidBodyDesc(Collider.cuboid(0.1, 0.5, 0.1), (0.5, 9.5, 0.0),
                                         body_type="dynamic", density=800.0),
                           RigidBodyDesc(Collider.cuboid(0.1, 0.5, 0.1), (1.0, 8.5, 0.0),
                                         body_type="dynamic", density=800.0)],
                          ((1, 0, (0.0, 0.5, 0.0), (0.0, 0.0, 0.0)),
                           (2, 1, (0.0, 0.5, 0.0), (0.0, -0.5, 0.0))))
    b = run(b, 3000)
    assert torch.isfinite(b.pos).all()
    assert max(R.anchor_gap(b, j) for j in joints) < 0.06
    assert float(b.pos[2, 1]) < float(b.pos[1, 1])


def test_fixed_joint_welds():
    run, b, (j,) = R.rig([R.PORT_ANCHOR, RigidBodyDesc(Collider.cuboid(0.1, 1.0, 0.1),
                                               (1.0, 9.0, 0.0), body_type="dynamic")],
                        ((1, 0, (-1.0, 1.0, 0.0), (0.0, 0.0, 0.0), "fixed"),))
    b = run(b, 2000)
    assert abs(float(b.pos[1, 0]) - 1.0) < 0.15
    assert float(b.rot[1, 1:].abs().max()) < 0.1 and R.anchor_gap(b, j) < 0.08


def test_2d_pendulum_chain_and_weld():
    """2D: a ball-jointed link swings and holds; a second link welded to it
    keeps its relative angle (2D revolute is the ball joint)."""
    run, b, joints = R.rig([RigidBodyDesc(Collider.ball(0.1), (0.0, 10.0)),
                           RigidBodyDesc(Collider.cuboid(0.1, 0.5), (0.5, 9.5),
                                         body_type="dynamic"),
                           RigidBodyDesc(Collider.cuboid(0.1, 0.5), (0.5, 8.5),
                                         body_type="dynamic")],
                          ((1, 0, (0.0, 0.5), (0.0, 0.0), "revolute", (0.0, 0.0, 1.0)),
                           (2, 1, (0.0, 0.5), (0.0, -0.5), "fixed")), 2)
    assert joints[0][4] == "ball"
    b = run(b, 1500)
    assert torch.isfinite(b.pos).all()
    assert abs(float(b.pos[1, 0]) - 0.5) > 0.05
    assert max(R.anchor_gap(b, j) for j in joints) < 0.05
    rel = pose.rot2_mul(torch.stack([b.rot[1, 0], -b.rot[1, 1]]), b.rot[2])
    assert abs(float(rel[1])) < 0.05
