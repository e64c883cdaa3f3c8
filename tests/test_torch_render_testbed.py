"""The port's render prep, headless Testbed and offline viewer:
tests/test_render_testbed.py's three tests on the port, the instance
colours against the JAX package's in every mode (2D and 3D), the PLY text
and the collider surface points against JAX's, and the Testbed's frame,
parameters and checkpoints against `step`.

Colours are equal bit for bit but in the volume mode, whose ramp reads
det F: torch.linalg.det and jnp.linalg.det (both LU) may differ in their
last bits, so the volume colours agree within 1e-6."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgsparkl_tpu import render as jrender
from wgsparkl_tpu import scenes as jscenes
from wgsparkl_tpu_torch import interop, render, scenes, viewer
from wgsparkl_tpu_torch import testbed
from wgsparkl_tpu_torch.pipeline import step
from wgsparkl_tpu_torch.solver import Particles
from torch_port_helpers import port_bodies, to_torch


def test_render_modes_and_ply(tmp_path):
    data = scenes.sand_box_3d(nxz=4, ny=8, cell_width=1.0, device="cpu")
    for name, mode in render.MODES.items():
        inst = render.prep_instances(data.state.particles, mode=mode, cell_width=1.0)
        col = inst["color"].numpy()
        assert col.shape == (data.num_particles, 3)
        assert np.isfinite(col).all() and col.min() >= 0.0
    path = str(tmp_path / "frame.ply")
    render.write_ply(path, inst, max_points=50)
    head = open(path).read().splitlines()
    assert head[0] == "ply" and "element vertex 50" in "\n".join(head[:5])


def test_testbed_frame_loop():
    inits = testbed.SceneInits(
        {"tiny": lambda: scenes.sand_box_3d(nxz=4, ny=8, device="cpu")})
    assert inits.names() == ["tiny"]
    tb = testbed.Testbed(inits.build("tiny"), num_substeps=2)
    stats = tb.run(3)
    assert stats["frames"] == 3 and stats["finite"]
    tb.run_state.gravity_factor = 0.0
    tb.step_frame()
    assert tb.frame == 4


def test_viewer_renders_and_roundtrips(tmp_path):
    data = scenes.sand_box_3d(nxz=4, ny=8, device="cpu")
    inst = render.prep_instances(data.state.particles)
    ply = str(tmp_path / "f.ply")
    render.write_ply(ply, inst)
    pos, col = viewer.read_ply(ply)
    assert pos.shape[1] == 3 and col.shape == pos.shape
    np.testing.assert_allclose(np.sort(pos[:, 1]),
                               np.sort(inst["position"].numpy()[:, 1]), atol=1e-3)
    img = viewer.render_instances(inst, width=320, height=240)
    assert img.shape == (240, 320, 3) and img.dtype == np.uint8
    assert (img != img[0, 0]).any()
    out = str(tmp_path / "tt.gif")
    viewer.turntable(pos, col, 0.25, out, n_frames=3, width=160, height=120)
    assert os.path.getsize(out) > 500
    render.write_ply(str(tmp_path / "frame_00001.ply"), inst)
    render.write_ply(str(tmp_path / "frame_00002.ply"), inst)
    viewer.main([str(tmp_path), "--out", str(tmp_path / "seq.gif"),
                 "--width", "160", "--height", "120"])
    assert os.path.getsize(str(tmp_path / "seq.gif")) > 500


def _jax_particles(dim, seed):
    """A JAX scene's particles with every field a mode reads made from a
    numpy seed (velocities, F near the identity, CDF normals and signed
    distances with zeros among them)."""
    d = (jscenes.sand_box_3d(nxz=4, ny=8) if dim == 3
         else jscenes.sand_column_2d(nx=8, ny=16, cell_width=0.5))
    p = d.state.particles
    rng = np.random.default_rng(seed)
    n = p.count
    sd = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    sd[::5] = 0.0
    return p.replace(
        vel=jnp.asarray(rng.uniform(-2, 2, (n, dim)), jnp.float32),
        def_grad=jnp.asarray(np.eye(dim) + 0.3 * rng.standard_normal((n, dim, dim)),
                             jnp.float32),
        cdf_normal=jnp.asarray(rng.uniform(-1, 1, (n, dim)), jnp.float32),
        cdf_signed_distance=jnp.asarray(sd))


@pytest.mark.parametrize("dim", [2, 3])
def test_instance_colours_equal_jax(dim, tmp_path):
    jp = _jax_particles(dim, 7 + dim)
    tp = Particles(**{f: to_torch(getattr(jp, f)) for f in (
        "pos", "vel", "def_grad", "affine", "init_volume", "init_radius", "mass",
        "cdf_normal", "cdf_rigid_vel", "cdf_signed_distance", "cdf_affinity", "ids")})
    assert list(render.MODES.items()) == list(jrender.MODES.items())
    for name, mode in render.MODES.items():
        ji = jrender.prep_instances(jp, mode=mode, cell_width=0.5)
        ti = render.prep_instances(tp, mode=mode, cell_width=0.5)
        jc, tc = np.asarray(ji["color"]), ti["color"].numpy()
        assert tc.shape == jc.shape == (jp.count, 3)
        if mode == render.MODE_VOLUME:
            np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(tc, jc, err_msg=name)
        for k in ("position", "deformation", "scale"):
            np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]))
    for mode in (render.MODE_VELOCITY, render.MODE_CDF_SIGNS):
        inst = render.prep_instances(tp, mode=mode)
        jrender.write_ply(str(tmp_path / "j.ply"), jrender.prep_instances(jp, mode=mode),
                          max_points=40)
        render.write_ply(str(tmp_path / "t.ply"), inst, max_points=40)
        assert open(tmp_path / "t.ply").read() == open(tmp_path / "j.ply").read()


def test_collider_surface_points_equal_jax():
    for jd in (jscenes.sand_box_3d(nxz=4, ny=8),
               jscenes.elastic_blocks_2d(n_side=16, cell_width=0.5)):
        b = jd.state.bodies
        ref = jrender.collider_surface_points(jd.bodies_desc, np.asarray(b.rot),
                                              np.asarray(b.pos), spacing=0.7)
        st = interop.state_from_reference(jd.state, "cpu")
        got = render.collider_surface_points(port_bodies(jd.bodies_desc), st.bodies.rot,
                                             st.bodies.pos, spacing=0.7)
        assert got.dtype == np.float32 and len(got) > 100
        np.testing.assert_array_equal(got, ref)


def test_testbed_frame_equals_step_and_resumes(tmp_path):
    """A Testbed frame is `step` of its substeps from the same state, bit for
    bit; params() is rebuilt only when the gravity factor changes; a saved
    and loaded checkpoint resumes the run bit for bit."""
    data = scenes.sand_box_3d(nxz=4, ny=8, device="cpu", by=8, group=256)
    state0 = data.state
    tb = testbed.Testbed(data, num_substeps=3)
    p1 = tb.params()
    assert tb.params() is p1 and torch.equal(p1.gravity, data.params.gravity)
    tb.step_frame()
    ref = step(state0, data.params, data.config, 3)
    for f in ("pos", "vel", "def_grad", "cdf_affinity"):
        assert torch.equal(getattr(tb.data.state.particles, f),
                           getattr(ref.particles, f))
    assert not tb.diag.any_overflow() and len(tb.frame_ms) == 1
    path = str(tmp_path / "tb.npz")
    tb.save_checkpoint(path)
    saved = tb.data.state
    tb.step_frame()
    after = tb.data.state
    tb.load_checkpoint(path)
    assert tb.frame == 1
    tb.step_frame()
    for f in ("pos", "vel", "def_grad", "affine", "cdf_affinity", "ids"):
        assert torch.equal(getattr(tb.data.state.particles, f),
                           getattr(after.particles, f))
    assert saved is not tb.data.state
    tb.run_state.gravity_factor = 0.5
    p2 = tb.params()
    assert p2 is not p1 and tb.params() is p2
    assert torch.equal(p2.gravity, data.params.gravity * 0.5)
    stats = tb.stats()
    assert stats["frames"] == 2 and stats["finite"] and stats["steps_per_s"] > 0
