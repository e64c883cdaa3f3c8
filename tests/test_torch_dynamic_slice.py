"""The port's step_pallas with dynamic bodies against the JAX package's on
the CPU (plain versions of every kernel, the rigid solve's included).

Two small scenes, 10 substeps each, every substep started in both
packages from the JAX package's state (the scenes start in contact, which
amplifies roundoff from substep to substep):
  * examples/sand2.py at n_side 48, the runner's smallest (chip_smoke's
    sand2_scene through the port's runner, held here against the example's
    own recipe in the JAX package): the light plate
    sunk 5 slops into the floor, the heavy one sunk 5 slops into it, and
    the lattice lowered onto them and the stirrers (CPIC impulses on the
    plates, plate-floor and plate-plate contacts);
  * the 3D sand box lattice (8 x 16 x 8, no paddle) lowered onto a dynamic
    plate of density 2000 sunk 2 slops into the floor.
Starting past the slop keeps every active contact sample's depth far from
the activity threshold (depth > 0), where roundoff could choose otherwise
in the two packages.  Particles: compare_states' tolerances (positions
1e-5, velocities and F 1e-4, affinity words exact).  Bodies: 1e-5 x
max(1, |reference|) (the JAX package contracts multiply-adds; the rigid
update amplifies its roundoff little over 10 substeps)."""

import jax
import numpy as np

import chip_smoke
import torch_port_helpers as H
from wgsparkl_tpu import scenes as jscenes
from wgsparkl_tpu.collision.shapes import Collider
from wgsparkl_tpu.models import DruckerPrager, ElasticCoefficients
from wgsparkl_tpu.models.drucker_prager import drucker_prager_arrays
from wgsparkl_tpu.params import SimulationParams
from wgsparkl_tpu.pipeline import MpmData, RigidBodyDesc
from wgsparkl_tpu.pipeline import step_pallas as j_step
from wgsparkl_tpu.solver import Models, Particles
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch.pipeline import step_pallas


_j_step = jax.jit(j_step, static_argnums=(2, 3))
N_SIDE = 48
SHIFT_2D = (0.0, -4.55)


def _jax_sand2(n_side, plates, shift):
    """examples/sand2.py lines 22-71 at SCALE = n_side / 700, the plates at
    `plates`, the lattice moved by `shift`, on the pallas path (group 128)."""
    scale, cw = n_side / 700, 0.2
    pos = jscenes._lattice((n_side, n_side), cw, (0.1, 46.0 * scale + 2.0))
    pos = pos + np.asarray(shift, np.float32)
    n = len(pos)
    elast = ElasticCoefficients.from_young_modulus(1e7, 0.2)
    dp = drucker_prager_arrays([DruckerPrager.new(1e7, 0.2)])
    models = Models.from_arrays(n, elast.lam, elast.mu,
                                dp={k: np.full(n, v[0]) for k, v in dp.items()})
    e = n_side * cw / 2
    bodies = [
        RigidBodyDesc(Collider.cuboid(e * 4, 1.0), (e / 2, -1.0)),
        RigidBodyDesc(Collider.cuboid(1.0, e * 4), (-e * 1.2, 0.0)),
        RigidBodyDesc(Collider.cuboid(1.0, e * 4), (e * 2.2, 0.0)),
        RigidBodyDesc(Collider.cuboid(e * 0.3, 0.4), (e * 0.5, e * 0.5),
                      body_type="kinematic", angvel=1.0),
        RigidBodyDesc(Collider.ball(e * 0.15), (e * 1.0, e * 0.8),
                      body_type="kinematic", angvel=1.0),
        RigidBodyDesc(Collider.capsule(e * 0.2, e * 0.08), (e * 0.2, e * 0.9),
                      body_type="kinematic", angvel=-1.0),
        RigidBodyDesc(Collider.cuboid(e * 0.15, 0.3), plates[0], body_type="dynamic",
                      density=500.0),
        RigidBodyDesc(Collider.cuboid(e * 0.15, 0.3), plates[1], body_type="dynamic",
                      density=2000.0),
    ]
    return MpmData(SimulationParams.new(dt=(1 / 60) / 10, gravity=[0.0, -9.81]),
                   Particles.from_arrays(pos, density=1000.0, radius=cw / 4), models,
                   bodies, cw,
                   grid_bounds=(np.array([-e * 1.6, -0.5]),
                                np.array([e * 2.6, 60.0 * scale + e * 1.5])),
                   transfer="pallas", group=H.GROUP_2D)


def _jax_plate_3d():
    d3 = jscenes.sand_box_3d(nxz=8, ny=16, cell_width=1.0, with_paddle=False)
    p = d3.state.particles
    p = p.replace(pos=p.pos + np.asarray([0.0, -4.0, 0.0], np.float32))
    plate = RigidBodyDesc(Collider.cuboid(1.2, 0.6, 1.2), (0.3, 0.5, -0.2),
                          rotation=(0.0, 0.3, 0.0), body_type="dynamic", density=2000.0)
    return MpmData(d3.params, p, d3.state.models, list(d3.bodies_desc) + [plate], 1.0,
                   grid=d3.config.grid, transfer="pallas", group=H.GROUP, job_chunk=8,
                   by=H.BY)


def _compare(ref, out, what):
    ij = np.argsort(np.asarray(ref.particles.ids))
    it = np.argsort(out.particles.ids.numpy())
    for f, tol in (("pos", 1e-5), ("vel", 1e-4), ("def_grad", 1e-4)):
        np.testing.assert_allclose(getattr(out.particles, f).numpy()[it],
                                   np.asarray(getattr(ref.particles, f))[ij],
                                   rtol=0, atol=tol, err_msg=f"{what}: {f}")
    np.testing.assert_array_equal(out.particles.cdf_affinity.numpy().view(np.uint32)[it],
                                  np.asarray(ref.particles.cdf_affinity)[ij])
    for f in ("pos", "rot", "linvel", "angvel"):
        r = np.asarray(getattr(ref.bodies, f))
        e = float(np.abs(getattr(out.bodies, f).numpy() - r).max())
        assert e <= 1e-5 * max(1.0, float(np.abs(r).max())), (what, f, e)


def _run(jdata, substeps=10):
    """substeps substeps, each started in both packages from the JAX
    package's state (the penetrating starts amplify roundoff from substep
    to substep), each compared; returns the port's last state and data."""
    cfg = interop.config_from_reference(jdata.config)
    tdata = H.port_data(jdata, chan_free=jdata.config.chan_free)
    assert cfg == tdata.config and cfg.dynamic_slots
    params = interop.params_from_reference(jdata.params, "cpu")
    state = jdata.state
    for k in range(substeps):
        ref = _j_step(state, jdata.params, jdata.config, 1)
        out = step_pallas(interop.state_from_reference(state, "cpu"), params, cfg, 1)
        _compare(ref, out, f"substep {k}")
        state = ref
    return out, tdata


def test_sand2_small_matches_jax():
    plates = chip_smoke.sand2_pressed(N_SIDE)
    jdata = _jax_sand2(N_SIDE, plates, SHIFT_2D)
    # chip_smoke's path-7 scene is the example's at this size.
    pdata = chip_smoke.sand2_scene("cpu", N_SIDE / 700, plates=plates, shift=SHIFT_2D,
                                   group=H.GROUP_2D)
    np.testing.assert_array_equal(pdata.state.particles.pos.numpy(),
                                  np.asarray(jdata.state.particles.pos))
    assert pdata.config == interop.config_from_reference(jdata.config)
    for f in ("rot", "pos", "angvel", "inv_mass", "inv_inertia_local", "shape_params"):
        np.testing.assert_array_equal(getattr(pdata.state.bodies, f).numpy(),
                                      np.asarray(getattr(jdata.state.bodies, f)))
    out, _ = _run(jdata)
    # The plates moved, and were pushed out of the floor and of each other.
    moved = out.bodies.pos[6:] - pdata.state.bodies.pos[6:]
    assert float(moved.abs().min()) > 0.0 and float(out.bodies.linvel[6, 1]) > 0.0


def test_plate_in_3d_lattice_matches_jax():
    out, tdata = _run(_jax_plate_3d())
    assert float(out.bodies.linvel[5, 1]) != 0.0
