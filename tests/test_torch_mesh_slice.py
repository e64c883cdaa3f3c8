"""The port's step_pallas on mesh-collider scenes against the JAX package's,
as tests/test_mesh_colliders.py runs its paths: 12 substeps of the 3D ramp
(by 4 and by 8) and of the 2D polyline tent in one frame each; 10 of a
kinematic spinning trimesh paddle lowered into the small sand box and 12
of the smallest elastic_cut3 block pressed onto its blades with fracture,
each substep from the JAX state (a penetrating start amplifies f32
roundoff from substep to substep, as in test_torch_slice_contact.py).
Tolerances: that file's path-vs-path ones (positions 5e-5, velocities
1e-3, affinity words exact, body poses 1e-6; the blades' velocities 2e-3,
see that test); fracture phases equal lane for lane.  In the
substep-by-substep scenes a particle whose stencil holds a node where
the two packages' mesh passes differ (a node on the plane of a
triangle's edge: the inside test is an exact zero there, which XLA:CPU's
multiply-adds tip either way) is held to its affinity word and phase
only; the most such particles in a substep is printed (ROADMAP queue
3)."""

import numpy as np
import pytest

import torch_mesh_scenes as M


@pytest.mark.parametrize("scene,substeps", [("ramp_by4", 12), ("ramp_by8", 12),
                                            ("tent_2d", 12), ("spinning_paddle", 10)])
def test_mesh_slice_matches_jax(scene, substeps):
    jd = {"ramp_by4": M.ramp, "ramp_by8": lambda: M.ramp(8), "tent_2d": M.tent,
          "spinning_paddle": M.spinning_paddle}[scene]()
    if scene == "spinning_paddle":
        ref, out, most = M.run_each(jd, substeps, M.compare_slice)
        print(f"{scene}: at most {most} particles by an edge-plane node")
        assert not np.array_equal(out.bodies.rot.numpy()[-1],
                                  np.asarray(jd.state.bodies.rot)[-1])
    else:
        ref, out = M.run_both(jd, substeps)
        M.compare_slice(ref, out)
    # Some particle's affinity names a mesh slot.
    aff = out.particles.cdf_affinity.numpy()
    assert any((aff & (1 << s)).any() for s in jd.config.mesh_cids)


def test_mesh_blades_fracture_matches_jax():
    """Velocities within 2e-3: on this scene (a stiff block pierced by the
    blades at 4 m/s) the JAX package's own dense and pallas paths differ
    by up to 1.4e-3 in velocity over these 12 substeps (positions by
    3e-6)."""
    def each(ref, out, skip):
        ij, it = M.compare_slice(ref, out, skip, vel_tol=2e-3)
        np.testing.assert_array_equal(out.models.phase.numpy()[it],
                                      np.asarray(ref.models.phase)[ij])

    jd = M.blades()
    ref, out, most = M.run_each(jd, 12, each)
    print(f"blades: at most {most} of {out.particles.count} particles by an "
          "edge-plane node")
    phase = np.asarray(ref.models.phase)
    print(f"blades: {int((phase == 0.0).sum())} lanes fractured")
    assert (phase == 0.0).sum() > 10 and (phase == 1.0).any()
