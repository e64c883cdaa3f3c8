"""Behaviour of the port's dynamic bodies on its own rigid loop (the plain
version of the rigid-solve kernel), as tests/test_contacts.py and
tests/test_joints.py check the JAX package's: a dynamic plate comes to rest
on the floor in 2D and 3D and falls through it without body contacts; two
dropped boxes settle as a stack; a beam dropped across another rests on it
through an edge-edge contact; a one-way body takes no CPIC impulse.  The
joints' behaviour: tests/test_torch_rigid_joints.py and
tests/test_torch_rigid_chain.py."""

import numpy as np
import pytest
import torch

import torch_rigid_scenes as R
from wgsparkl_tpu_torch.collision.shapes import Collider
from wgsparkl_tpu_torch.pipeline import COUPLING_ONE_WAY, COUPLING_TWO_WAY, RigidBodyDesc

torch.set_num_threads(1)
DT, H = 1 / 240, 0.5


def _floor(dim):
    return (RigidBodyDesc(Collider.cuboid(10.0, 0.5, 10.0), (0.0, -0.5, 0.0)) if dim == 3
            else RigidBodyDesc(Collider.cuboid(10.0, 0.5), (0.0, -0.5)))


def _plate(dim):
    return RigidBodyDesc(Collider.cuboid(0.6, 0.1, 0.6) if dim == 3
                         else Collider.cuboid(0.6, 0.1),
                         (0.0, 1.5, 0.0)[:dim], body_type="dynamic", density=800.0)


@pytest.mark.parametrize("dim", [2, 3])
def test_dynamic_plate_rests_on_floor(dim):
    run, b, _ = R.rig([_floor(dim), _plate(dim)], dim=dim, dt=DT, cell_width=H)
    b = run(b, 300)
    assert abs(float(b.pos[1, 1]) - 0.1) < 0.05, b.pos[1]
    assert float(torch.linalg.norm(b.linvel[1])) < 0.1, b.linvel[1]


def test_without_contacts_plate_falls_through():
    run, b, _ = R.rig([_floor(3), _plate(3)], dt=DT, cell_width=H, body_contacts=False)
    assert float(run(b, 300).pos[1, 1]) < -0.5


def test_stacked_dynamic_boxes_settle():
    run, b, _ = R.rig([_floor(3),
                       RigidBodyDesc(Collider.cuboid(0.6, 0.2, 0.6), (0.0, 0.6, 0.0),
                                     body_type="dynamic", density=800.0),
                       RigidBodyDesc(Collider.cuboid(0.4, 0.2, 0.4), (0.05, 1.6, 0.0),
                                     body_type="dynamic", density=800.0)],
                      dt=DT, cell_width=H)
    b = run(b, 400)
    assert abs(float(b.pos[1, 1]) - 0.2) < 0.07, b.pos[1]
    assert abs(float(b.pos[2, 1]) - 0.6) < 0.12, b.pos[2]
    assert float(torch.linalg.norm(b.linvel[1:], dim=-1).max()) < 0.2


def test_crossed_boxes_edge_edge_contact():
    run, b, _ = R.rig([RigidBodyDesc(Collider.cuboid(5.0, 0.2, 0.2), (0.0, 1.0, 0.0)),
                       RigidBodyDesc(Collider.cuboid(0.2, 0.2, 5.0), (0.0, 2.0, 0.0),
                                     body_type="dynamic", density=800.0)],
                      dt=DT, cell_width=H)
    assert 1.25 < float(run(b, 400).pos[1, 1]) < 1.55


def test_one_way_coupling_masks_impulses():
    from wgsparkl_tpu_torch.grid import GridConfig
    from wgsparkl_tpu_torch.params import SimulationParams
    from wgsparkl_tpu_torch.pipeline import MpmConfig, build_rigid_world, rigid_bodies_update
    from wgsparkl_tpu_torch.rigid import body as body_mod

    descs = [_floor(3), _plate(3)]
    b = body_mod.update_world_mass_properties(build_rigid_world(descs, 3, "cpu"))
    params = SimulationParams.new(DT, [0.0, -9.81, 0.0], device="cpu")
    lin = torch.zeros(2, 3)
    lin[1, 1] = 50.0
    grid = GridConfig.from_bounds(np.full(3, -3.0), np.full(3, 8.0), H)
    out = {}
    for mode in (COUPLING_ONE_WAY, COUPLING_TWO_WAY):
        cfg = MpmConfig(grid=grid, collider_types=(0, 0), coupling=(COUPLING_TWO_WAY, mode))
        out[mode] = rigid_bodies_update(b, lin, torch.zeros(2, 3), params, cfg)
    np.testing.assert_allclose(out[COUPLING_ONE_WAY].linvel[1].numpy(),
                               [0.0, -9.81 * params.dt, 0.0], atol=1e-6)
    # 50 / the plate's 230.4 kg, less one gravity kick.
    assert float(out[COUPLING_TWO_WAY].linvel[1, 1]) > 0.15
