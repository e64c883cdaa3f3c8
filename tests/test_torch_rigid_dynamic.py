"""The port's dynamic rigid bodies against the JAX package on the CPU: mass
properties, the dynamic RigidWorld, boundary projection, normalised
joints, and `rigid_bodies_update` with per-body coupling, body contacts
on the scenes of tests/test_contacts.py (plain versions of the rigid-solve
kernel; tests/test_joints.py's scenes: tests/test_torch_rigid_joints.py).

Inputs come from numpy seeds.  Tolerances: one rigid update within 1e-5 x
max(1, |reference|) of the JAX package's (XLA:CPU contracts multiply-adds
and orders its small matrix products otherwise); 50 chained updates within
1e-4 x max(1, |reference|): the Gauss-Seidel sweeps carry that roundoff
from update to update.  JAX fails on every 2D joint (its per-axis dynamic
mask of shape [2] meets the [1] angular velocity), so 2D joints are held
by the port's own behaviour (tests/test_torch_rigid_joints.py,
tests/test_torch_rigid_chain.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rigid_scenes as R
from wgsparkl_tpu import pipeline as JP
from wgsparkl_tpu.collision import shapes as jshp
from wgsparkl_tpu.rigid import body as jbody
from wgsparkl_tpu_torch import pipeline as P
from wgsparkl_tpu_torch.collision import shapes as tshp
from wgsparkl_tpu_torch.rigid import body as tbody


D = "dynamic"


def _shape(kind, dim, rng):
    if kind == "cuboid":
        return jshp.Collider.cuboid(*rng.uniform(0.1, 1.0, dim))
    if kind == "ball":
        return jshp.Collider.ball(rng.uniform(0.1, 1.0))
    return jshp.Collider.capsule(*rng.uniform(0.1, 1.0, 2))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", ["cuboid", "ball", "capsule"])
def test_mass_properties_and_dynamic_world_match_jax(kind, dim):
    rng = np.random.default_rng(3 + dim)
    descs = []
    for i in range(3):
        col = _shape(kind, dim, rng)
        rot = rng.uniform(-1, 1, 3) if dim == 3 else float(rng.uniform(-1, 1))
        descs.append(JP.RigidBodyDesc(col, tuple(rng.uniform(-2, 2, dim)), rotation=rot,
                                      body_type=D if i else "kinematic",
                                      density=float(rng.uniform(300, 3000)),
                                      angvel=None if i else (1.0 if dim == 2 else (0, 1, 0))))
        m_j, com_j, i_j = jbody.shape_mass_properties(col, descs[-1].density, dim)
        m_t, com_t, i_t = tbody.shape_mass_properties(R.port_desc(descs[-1]).collider,
                                                      descs[-1].density, dim)
        assert m_t == m_j
        np.testing.assert_array_equal(com_t, com_j)
        np.testing.assert_array_equal(i_t, i_j)
    jw = JP.build_rigid_world(tuple(descs), dim)
    tw = P.build_rigid_world([R.port_desc(d) for d in descs], dim, "cpu")
    for f in ("rot", "pos", "linvel", "angvel", "inv_mass", "inv_inertia_local",
              "inv_inertia_world", "shape_params"):
        np.testing.assert_array_equal(getattr(tw, f).numpy(), np.asarray(getattr(jw, f)),
                                      err_msg=f)
    assert (tw.inv_mass[1:] > 0).all() and not tw.inv_mass[0].any()


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("st", [0, 1, 2, 3])
def test_project_on_boundary_matches_jax(st, dim):
    rng = np.random.default_rng(10 * st + dim)
    params = np.zeros(8, np.float32)
    params[:3] = rng.uniform(0.3, 1.5, 3)
    rot = (rng.normal(size=4) if dim == 3 else rng.normal(size=2)).astype(np.float32)
    rot /= np.linalg.norm(rot)
    trans = rng.uniform(-1, 1, dim).astype(np.float32)
    pts = rng.uniform(-2.5, 2.5, (200, dim)).astype(np.float32)
    dj, ij = jshp.project_on_boundary(st, jnp.asarray(params), jnp.asarray(rot),
                                      jnp.asarray(trans), jnp.asarray(pts))
    dt, it = tshp.project_on_boundary(st, torch.as_tensor(params), torch.as_tensor(rot),
                                      torch.as_tensor(trans), torch.as_tensor(pts))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert 0 < int(it.sum()) < len(pts)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=2e-6)


def test_normalize_joints_matches_jax():
    rng = np.random.default_rng(5)
    for dim in (2, 3):
        descs = [JP.RigidBodyDesc(jshp.Collider.ball(0.1), tuple(rng.uniform(-1, 1, dim)),
                                  rotation=(rng.uniform(-1, 1, 3) if dim == 3
                                            else float(rng.uniform(-1, 1)))),
                 JP.RigidBodyDesc(jshp.Collider.cuboid(*[0.3] * dim),
                                  tuple(rng.uniform(-1, 1, dim)),
                                  rotation=(rng.uniform(-1, 1, 3) if dim == 3
                                            else float(rng.uniform(-1, 1))), body_type=D)]
        z, a = (0.0,) * dim, tuple(rng.uniform(-1, 1, dim))
        joints = [(1, 0, a, z), (1, 0, a, z, "ball"), (1, 0, z, a, "fixed"),
                  (0, 1, a, a, "revolute", tuple(rng.uniform(-1, 1, 3))),
                  (1, 0, z, z, "prismatic", tuple(rng.uniform(-1, 1, dim)))]
        jn = JP._normalize_joints(tuple(joints), tuple(descs), dim)
        tn = P._normalize_joints(tuple(joints), [R.port_desc(d) for d in descs], dim)
        for jj, tj in zip(jn, tn):
            assert jj[:2] == tj[:2] and jj[4] == tj[4] and jj[2:4] == tj[2:4]
            flat = lambda e: np.asarray(  # noqa: E731
                [] if e is None else np.concatenate([np.ravel(x) for x in e])
                if isinstance(e[0], tuple) else e, np.float64)
            np.testing.assert_allclose(flat(tj[5]), flat(jj[5]), rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        P._normalize_joints(((1, 0, z, z, "hinge"),), [R.port_desc(d) for d in descs], 3)


@pytest.mark.parametrize("name", R.CONTACT_SCENES)
def test_rigid_bodies_update_matches_jax(name):
    """Contacts with one-way and two-way coupling, and without contacts
    (tests/test_joints.py's scenes: tests/test_torch_rigid_joints.py)."""
    first, start, tcfg, tparams = R.update_matches_jax(name)
    if name == "one_way":
        # The one-way plate took no CPIC impulse: only gravity and contacts.
        free = P.rigid_bodies_update(start, torch.zeros(2, 3), torch.zeros(2, 3), tparams,
                                     tcfg)
        np.testing.assert_array_equal(first.linvel[1].numpy(), free.linvel[1].numpy())
