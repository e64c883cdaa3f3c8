"""The kernel path's CDF plan (wgsparkl_tpu_torch/pipeline.py `_cdf_plan`),
decided once a frame from the configuration and the entry: for each CDF
mode, the mode, what the frame hoists and the (slot, shape) descriptors the
kernels evaluate in-kernel, as the module docstring sets them out.

The scenes are the port's small ones: the sand box (8 x 8 x 8 grains, its
five fixed walls and its kinematic paddle) as it is, with a trimesh ramp
beside it, chan-free and in the sparse domain; the 2D sand column (16 x 32
grains on its fixed floor) as it is, stirred by a kinematic ball, chan-free,
and with no collider at all."""

import numpy as np
import pytest

from wgsparkl_tpu_torch import scenes
from wgsparkl_tpu_torch.collision import shapes as shp
from wgsparkl_tpu_torch.collision.shapes import Collider
from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc, _cdf_plan, _hoist

CUB = shp.SHAPE_CUBOID
WALLS = tuple((i, CUB) for i in range(5))      # the sand box's fixed walls
PADDLE = ((5, CUB),)                           # its kinematic paddle


def _box(**kw) -> MpmData:
    return scenes.sand_box_3d(nxz=8, ny=8, device="cpu", **kw)


def _column(**kw) -> MpmData:
    return scenes.sand_column_2d(nx=16, ny=32, cell_width=0.5, group=128, device="cpu",
                                 **kw)


def _with(d: MpmData, extra, keep: bool = True) -> MpmData:
    """d's particles and grid with extra bodies (keep: after d's own; else
    in their place)."""
    bodies = (list(d.bodies_desc) if keep else []) + list(extra)
    return MpmData(d.params, d.state.particles, d.state.models, bodies,
                   d.config.grid.cell_width, grid=d.config.grid,
                   group=d.config.group, chan_free=False)


def _ramp():
    v = np.array([[-3, 1, -3], [3, 1, -3], [3, 3, 3], [-3, 3, 3]], np.float32)
    return RigidBodyDesc(Collider.trimesh(v, np.array([[0, 1, 2], [0, 2, 3]], np.int32)),
                         (0.0, 0.0, 0.0))


def _ball():
    return RigidBodyDesc(Collider.ball(0.8), (-1.5, 1.5), body_type="kinematic",
                         angvel=1.0)


# name: (scene, entry hoists, (mode, hoist, chan_free, static_desc, moving,
# alldesc)).
CASES = {
    "3d_gathered": (lambda: _box(chan_free=False), True,
                    ("gathered", "chan", False, WALLS, PADDLE, ())),
    "3d_dense_mesh": (lambda: _with(_box(chan_free=False), [_ramp()]), True,
                      ("dense", "triple", False, (), (), ())),
    "3d_chan_free": (lambda: _box(chan_free=True), True,
                     ("chan_free", "", True, WALLS, PADDLE, ())),
    "3d_sparse": (lambda: _box(chan_free=False, sparse=True), True,
                  ("sparse", "", False, (), (), ())),
    "2d_gathered": (lambda: _column(chan_free=False), True,
                    ("gathered", "chan", False, (), (), ())),
    "2d_dense": (lambda: _with(_column(chan_free=False), [_ball()]), True,
                 ("dense", "triple", False, (), (), ())),
    "2d_chan_free": (lambda: _column(chan_free=True), True,
                     ("chan_free", "", True, (), (), ((0, CUB),))),
    "collider_free": (lambda: _with(_column(chan_free=False), [], keep=False), True,
                      ("none", "", False, (), (), ())),
    "substep_pallas": (lambda: _box(chan_free=False), False,
                       ("dense", "", False, (), (), ())),
}


@pytest.mark.parametrize("name", list(CASES))
def test_cdf_plan(name):
    """The plan of each mode, and the frame hoist it asks for: a channel
    grid with the triple, the triple alone, or nothing."""
    build, hoist, want = CASES[name]
    d = build()
    plan = _cdf_plan(d.config, hoist)
    assert (plan.mode, plan.hoist, plan.chan_free, plan.static_desc, plan.moving,
            plan.alldesc) == want
    chan, tri = _hoist(d.state.bodies, d.config, plan)
    assert (chan is not None, tri is not None) == (plan.hoist == "chan", bool(plan.hoist))
