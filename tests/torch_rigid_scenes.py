"""Scenes of the rigid-body tests of the port (tests/test_torch_rigid_*.py):
the bodies of tests/test_contacts.py's and tests/test_joints.py's scenes,
built in the JAX package, with their configurations in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from wgsparkl_tpu import pipeline as JP
from wgsparkl_tpu.collision import shapes as jshp
from wgsparkl_tpu.grid import GridConfig as JGrid
from wgsparkl_tpu.params import SimulationParams as JParams
from wgsparkl_tpu.rigid import body as jbody
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch import pipeline as P
from wgsparkl_tpu_torch.collision import shapes as tshp
from wgsparkl_tpu_torch.grid import GridConfig as TGrid
from wgsparkl_tpu_torch.math import pose as tpose
from wgsparkl_tpu_torch.params import SimulationParams as TParams
from wgsparkl_tpu_torch.rigid import body as tbody

D = "dynamic"
BALL_ANCHOR = JP.RigidBodyDesc(jshp.Collider.ball(0.1), (0.0, 10.0, 0.0))
_j_update = jax.jit(JP.rigid_bodies_update, static_argnums=(4,))


def port_desc(d):
    return P.RigidBodyDesc(tshp.Collider(d.collider.shape_type, tuple(d.collider.params)),
                           tuple(d.translation), d.rotation, d.body_type, d.density,
                           d.linvel, d.angvel)


def contact_scene(name):
    """(bodies, dim, coupling, body_contacts) of tests/test_contacts.py's
    scenes, started in contact (tilted and sunk past the slop), and two
    scenes of a dynamic ball and capsule touching each other, a halfspace
    and a spinning kinematic ball."""
    C = jshp.Collider
    floor3 = JP.RigidBodyDesc(C.cuboid(10.0, 0.5, 10.0), (0.0, -0.5, 0.0))
    floor2 = JP.RigidBodyDesc(C.cuboid(10.0, 0.5), (0.0, -0.5))
    plate3 = JP.RigidBodyDesc(C.cuboid(0.6, 0.1, 0.6), (0.0, 0.07, 0.0),
                              rotation=(0.05, 0.0, 0.03), body_type=D, density=800.0)
    if name == "plate_2d":
        return [floor2, JP.RigidBodyDesc(C.cuboid(0.6, 0.1), (0.0, 0.07), rotation=0.05,
                                         body_type=D, density=800.0)], 2, None, True
    if name == "plate_3d":
        return [floor3, plate3], 3, None, True
    if name == "one_way":
        return [floor3, plate3], 3, (2, 1), True
    if name == "no_contacts":
        return [floor3, plate3], 3, None, False
    if name == "stacked":
        return [floor3,
                JP.RigidBodyDesc(C.cuboid(0.6, 0.2, 0.6), (0.0, 0.17, 0.0), body_type=D,
                                 density=800.0),
                JP.RigidBodyDesc(C.cuboid(0.4, 0.2, 0.4), (0.05, 0.55, 0.0),
                                 rotation=(0.0, 0.2, 0.04), body_type=D, density=800.0)
                ], 3, None, True
    if name == "crossed":
        return [JP.RigidBodyDesc(C.cuboid(5.0, 0.2, 0.2), (0.0, 1.0, 0.0)),
                JP.RigidBodyDesc(C.cuboid(0.2, 0.2, 5.0), (0.0, 1.37, 0.0),
                                 rotation=(0.0, 0.0, 0.02), body_type=D, density=800.0)
                ], 3, None, True
    if name == "shapes_3d":
        return [JP.RigidBodyDesc(C.halfspace(), (0.0, -0.02, 0.0)),
                JP.RigidBodyDesc(C.ball(0.3), (0.25, 0.27, 0.0), body_type=D, density=600.0),
                JP.RigidBodyDesc(C.capsule(0.3, 0.1), (-0.1, 0.07, 0.1), rotation=(1.5, 0, 0),
                                 body_type=D, density=900.0),
                JP.RigidBodyDesc(C.ball(0.5), (-0.6, 0.3, 0.3), body_type="kinematic",
                                 angvel=(0.0, 1.0, 0.0))], 3, None, True
    assert name == "shapes_2d"
    return [JP.RigidBodyDesc(C.halfspace(), (0.0, -0.02), rotation=0.01),
            JP.RigidBodyDesc(C.capsule(0.3, 0.1), (0.1, 0.3), rotation=1.2, body_type=D,
                             density=800.0),
            JP.RigidBodyDesc(C.ball(0.2), (0.45, 0.15), body_type=D, density=700.0),
            JP.RigidBodyDesc(C.ball(0.5), (-0.5, 0.4), body_type="kinematic", angvel=1.0)
            ], 2, None, True


def joint_scene(name):
    """(bodies, joints) of tests/test_joints.py's scenes."""
    C = jshp.Collider
    if name == "pendulum":
        return [BALL_ANCHOR, JP.RigidBodyDesc(C.cuboid(0.1, 1.0, 0.1), (1.0, 9.0, 0.0),
                                              body_type=D)], \
            ((1, 0, (0.0, 1.0, 0.0), (0.0, 0.0, 0.0)),)
    if name == "chain":
        return [BALL_ANCHOR,
                JP.RigidBodyDesc(C.cuboid(0.1, 0.5, 0.1), (0.5, 9.5, 0.0), body_type=D,
                                 density=800.0),
                JP.RigidBodyDesc(C.cuboid(0.1, 0.5, 0.1), (1.0, 8.5, 0.0), body_type=D,
                                 density=800.0)], \
            ((1, 0, (0.0, 0.5, 0.0), (0.0, 0.0, 0.0)),
             (2, 1, (0.0, 0.5, 0.0), (0.0, -0.5, 0.0)))
    if name == "fixed":
        return [BALL_ANCHOR, JP.RigidBodyDesc(C.cuboid(0.1, 1.0, 0.1), (1.0, 9.0, 0.0),
                                              body_type=D)], \
            ((1, 0, (-1.0, 1.0, 0.0), (0.0, 0.0, 0.0), "fixed"),)
    if name == "revolute":
        return [BALL_ANCHOR, JP.RigidBodyDesc(C.cuboid(1.0, 0.1, 0.1), (1.0, 10.0, 0.0),
                                              body_type=D)], \
            ((1, 0, (-1.0, 0.0, 0.0), (0.0, 0.0, 0.0), "revolute", (0.0, 0.0, 1.0)),)
    axis = {"prismatic_x": (1.0, 0.0, 0.0), "prismatic_y": (0.0, 1.0, 0.0),
            "prismatic_tilted": (0.3, 0.2, 0.9)}[name]
    return [BALL_ANCHOR, JP.RigidBodyDesc(C.cuboid(0.3, 0.2, 0.2), (0.0, 10.0, 0.0),
                                          rotation=(0.1, 0.0, 0.2), body_type=D)], \
        ((1, 0, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), "prismatic", axis),)


CONTACT_SCENES = ("plate_2d", "plate_3d", "stacked", "crossed", "one_way", "no_contacts",
                  "shapes_3d", "shapes_2d")
JOINT_SCENES = ("pendulum", "chain", "fixed", "revolute", "prismatic_x", "prismatic_y",
                "prismatic_tilted")


def configs(name):
    """The JAX package's (bodies, MpmConfig, params) of a scene and the
    port's (config, params)."""
    if name in CONTACT_SCENES:
        descs, dim, coupling, contacts = contact_scene(name)
        joints = ()
    else:
        (descs, joints), dim, coupling, contacts = joint_scene(name), 3, None, True
    dyn = tuple(i for i, d in enumerate(descs) if d.body_type == D)
    jcfg = JP.MpmConfig(
        grid=JGrid.from_bounds(np.full(dim, -8.0), np.full(dim, 16.0), 0.5),
        collider_types=tuple(d.collider.shape_type for d in descs),
        dynamic_slots=dyn if contacts else (),
        coupling=tuple(coupling or (2,) * len(descs)), transfer="pallas",
        joints=JP._normalize_joints(joints, tuple(descs), dim))
    jparams = JParams.new(dt=1 / 240, gravity=[0.0, -9.81, 0.0][:dim])
    tcfg = interop.config_from_reference(jcfg)
    assert tcfg.joints == P._normalize_joints(joints, [port_desc(d) for d in descs], dim)
    return descs, dim, jcfg, jparams, tcfg, interop.params_from_reference(jparams, "cpu")


def within(out, ref, rtol, what):
    for f in ("pos", "rot", "linvel", "angvel"):
        r = np.asarray(getattr(ref, f))
        e = float(np.abs(getattr(out, f).numpy() - r).max())
        assert e <= rtol * max(1.0, float(np.abs(r).max())), (what, f, e)


def update_matches_jax(name):
    """The port's rigid_bodies_update against the JAX package's on scene
    `name`: random CPIC impulses (numpy seed) on the first of 50 chained
    updates, none after; within 1e-5 x max(1, |reference|) after one, 1e-4
    after each later one.  Returns the port's first update and the world
    it started from."""
    descs, dim, jcfg, jparams, tcfg, tparams = configs(name)
    jw = jbody.update_world_mass_properties(JP.build_rigid_world(tuple(descs), dim))
    tw = tbody.update_world_mass_properties(
        P.build_rigid_world([port_desc(d) for d in descs], dim, "cpu"))
    start = tw
    rng = np.random.default_rng((CONTACT_SCENES + JOINT_SCENES).index(name))
    na = 3 if dim == 3 else 1
    lin = rng.normal(0.0, 20.0, (len(descs), dim)).astype(np.float32)
    ang = rng.normal(0.0, 2.0, (len(descs), na)).astype(np.float32)
    first = None
    for k in range(50):
        jo = _j_update(jw, jnp.asarray(lin), jnp.asarray(ang), jparams, jcfg)
        to = P.rigid_bodies_update(tw, torch.as_tensor(lin), torch.as_tensor(ang), tparams,
                                   tcfg)
        within(to, jo, 1e-5 if k == 0 else 1e-4, f"{name}, update {k}")
        first = to if k == 0 else first
        jw = jbody.update_world_mass_properties(jo)
        tw = tbody.update_world_mass_properties(to)
        lin, ang = 0.0 * lin, 0.0 * ang
    return first, start, tcfg, tparams


# ---- the port's own rigid loop (behaviour checks) ----
def rig(descs, joints=(), dim=3, dt=1e-3, cell_width=1.0, body_contacts=True):
    """(run(bodies, n) -> bodies after n rigid substeps of dt with no CPIC
    impulse, the initial bodies, the normalised joints) of the port's
    bodies descs."""
    grid = TGrid.from_bounds(np.full(dim, -8.0), np.full(dim, 16.0), cell_width)
    joints = P._normalize_joints(joints, descs, dim)
    dyn = tuple(i for i, d in enumerate(descs) if d.body_type == "dynamic")
    cfg = P.MpmConfig(grid=grid, collider_types=tuple(d.collider.shape_type for d in descs),
                      dynamic_slots=dyn if body_contacts else (),
                      coupling=(2,) * len(descs), joints=joints)
    params = TParams.new(dt, [0.0, -9.81, 0.0][:dim], device="cpu")
    zl = torch.zeros((len(descs), dim))
    za = torch.zeros((len(descs), 3 if dim == 3 else 1))

    def run(b, n):
        with torch.inference_mode():
            for _ in range(n):
                b = P.rigid_bodies_update(tbody.update_world_mass_properties(b), zl, za,
                                          params, cfg)
        return b

    return run, P.build_rigid_world(descs, dim, "cpu"), joints


def anchor_gap(b, j):
    dim = b.dim
    la = [torch.tensor(j[2][:dim]), torch.tensor(j[3][:dim])]
    a = [tpose.transform_point(b.rot[s], b.pos[s], x) for s, x in zip(j[:2], la)]
    return float(torch.linalg.norm(a[0] - a[1]))


PORT_ANCHOR = P.RigidBodyDesc(tshp.Collider.ball(0.1), (0.0, 10.0, 0.0))
