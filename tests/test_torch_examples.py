"""The port's example runners (wgsparkl_tpu_torch/examples) against the
JAX package's examples/*.py: each runner's `build(scale, "cpu")` at a small
SCALE gives the JAX example's scene at that SCALE: the particles and models
bit for bit (the material table too), the bodies' descriptions and states
(1e-6), the mesh samples (bit for bit but their positions, 1e-5), the grid
and the configuration.

The JAX examples run on import; `jax_example` loads one with runpy after
putting a stand-in `common` module into sys.modules whose run_example only
captures the MpmData, so no frame is stepped."""

import dataclasses
import importlib
import os
import pathlib
import runpy
import sys
import types

import numpy as np
import pytest
import torch

from wgsparkl_tpu_torch import interop


EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
NAMES = ("sand2", "sand3", "elasticity2", "elastic_cut2", "elastic_cut3",
         "heightfield3", "dam_break3")
# A small SCALE each (the examples clamp their lattices from below).
SCALES = {"sand2": 0.05, "sand3": 0.1, "elasticity2": 0.05, "elastic_cut2": 0.05,
          "elastic_cut3": 0.1, "heightfield3": 0.1, "dam_break3": 0.1}


def _stand_in_common(captured):
    def transfer_kw():
        kw = {"transfer": os.environ.get("TRANSFER", "pallas")}
        if kw["transfer"] in ("blocked", "pallas"):
            kw["group"] = int(os.environ.get("GROUP", 256))
        return kw

    def run_example(data, num_substeps, **kw):
        captured["data"], captured["substeps"] = data, num_substeps
        return types.SimpleNamespace(data=data)

    mod = types.ModuleType("common")
    mod.transfer_kw, mod.run_example = transfer_kw, run_example
    return mod


def jax_example(name: str, scale: float):
    """(the JAX example's MpmData at SCALE=scale, its substeps a frame)."""
    captured = {}
    saved = sys.modules.get("common"), list(sys.path), os.environ.get("SCALE")
    sys.modules["common"] = _stand_in_common(captured)
    os.environ["SCALE"] = str(scale)
    try:
        runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="example")
    finally:
        if saved[0] is None:
            sys.modules.pop("common", None)
        else:
            sys.modules["common"] = saved[0]
        sys.path[:] = saved[1]
        if saved[2] is None:
            os.environ.pop("SCALE", None)
        else:
            os.environ["SCALE"] = saved[2]
    return captured["data"], captured["substeps"]


def _eq(t, a, what):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    np.testing.assert_array_equal(t.cpu().numpy(), a, err_msg=what)


def _same_body(t, j):
    tc, jc = t.collider, j.collider
    assert (tc.shape_type, tuple(tc.params)) == (jc.shape_type, tuple(jc.params))
    for f in ("vertices", "indices"):
        a, b = getattr(tc, f), getattr(jc, f)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for f in ("translation", "rotation", "linvel", "angvel"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a, np.float64),
                                          np.asarray(b, np.float64))
    assert (t.body_type, t.density) == (j.body_type, j.density)


@pytest.mark.parametrize("name", NAMES)
def test_runner_builds_the_examples_scene(name, monkeypatch):
    for var in ("TRANSFER", "GROUP", "BY"):
        monkeypatch.delenv(var, raising=False)
    jdata, substeps = jax_example(name, SCALES[name])
    runner = importlib.import_module(f"wgsparkl_tpu_torch.examples.{name}")
    tdata = runner.build(SCALES[name], "cpu")
    assert tdata.config == interop.config_from_reference(jdata.config)
    assert tdata.num_particles == jdata.num_particles
    js, ts = jdata.state, tdata.state
    for f in ("pos", "vel", "def_grad", "affine", "init_volume", "init_radius", "mass",
              "cdf_affinity", "ids"):
        _eq(getattr(ts.particles, f), getattr(js.particles, f), f)
    for f in ("lam", "mu", "phase", "max_stretch", "mat_id", "mat_table"):
        _eq(getattr(ts.models, f), getattr(js.models, f), f)
    for k in js.models.dp:
        _eq(ts.models.dp[k], js.models.dp[k], k)
    params = interop.params_from_reference(jdata.params, "cpu")
    assert tdata.params.dt == params.dt and torch.equal(tdata.params.gravity,
                                                        params.gravity)
    assert len(tdata.bodies_desc) == len(jdata.bodies_desc)
    for t, j in zip(tdata.bodies_desc, jdata.bodies_desc):
        _same_body(t, j)
    for f in dataclasses.fields(ts.bodies):
        np.testing.assert_allclose(getattr(ts.bodies, f.name).numpy(),
                                   np.asarray(getattr(js.bodies, f.name)),
                                   rtol=1e-6, atol=1e-6, err_msg=f.name)
    assert (ts.meshes is None) == (js.meshes is None)
    if ts.meshes is not None:
        for f in dataclasses.fields(ts.meshes):
            t, j = getattr(ts.meshes, f.name), getattr(js.meshes, f.name)
            if f.name == "sample_local":
                # The JAX package samples with its own C++ build
                # (-march=native, contracted multiply-adds): 1 ulp apart on
                # a few samples (tests/test_torch_mesh_sampling.py's 1e-5).
                np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)
            else:
                _eq(t, j, f.name)
    if name == "dam_break3":
        assert substeps == runner.SUBSTEPS == 20


@pytest.mark.parametrize("name", ("sand3", "dam_break3"))
def test_build_reads_no_environment(name, monkeypatch):
    """`build` takes the transfer, group and by as arguments: the
    environment reaches the scene only through the script's `env_kw`, and
    then as the JAX example reads it."""
    from wgsparkl_tpu_torch.examples import common

    runner = importlib.import_module(f"wgsparkl_tpu_torch.examples.{name}")
    for var in ("TRANSFER", "GROUP", "BY"):
        monkeypatch.delenv(var, raising=False)
    plain = runner.build(SCALES[name], "cpu").config
    for k, v in {"TRANSFER": "blocked", "GROUP": "128", "BY": "4"}.items():
        monkeypatch.setenv(k, v)
    assert runner.build(SCALES[name], "cpu").config == plain
    kw = common.env_kw("BY") if name == "dam_break3" else common.env_kw()
    cfg = runner.build(SCALES[name], "cpu", **kw).config
    assert (cfg.transfer, cfg.group) == ("blocked", 128) != (plain.transfer, plain.group)
    jdata, _ = jax_example(name, SCALES[name])
    # The JAX package keeps its material table for the pallas path only.
    assert dataclasses.replace(cfg, n_materials=1) == \
        interop.config_from_reference(jdata.config)


def test_dam_break_runner_at_full_size_counts():
    """SCALE 1.25 is BASELINE config 3's ~256k: 250,000 fluid and 15,625
    elastic particles (counted, not built)."""
    from wgsparkl_tpu_torch.examples import dam_break3

    nf, ne = dam_break3.counts(1.25)
    assert (2 * nf ** 3, ne ** 3) == (250_000, 15_625)


def test_runner_main_runs_on_the_cpu_when_asked(monkeypatch, tmp_path, capsys):
    """DEVICE=cpu: a frame of the dam break at its smallest size, a PLY dump
    into DUMP_DIR, stats printed."""
    from wgsparkl_tpu_torch.examples import dam_break3

    for k, v in {"DEVICE": "cpu", "SCALE": "0.1", "FRAMES": "1", "PLY_EVERY": "1",
                 "DUMP_DIR": str(tmp_path), "GROUP": "256"}.items():
        monkeypatch.setenv(k, v)
    dam_break3.main()
    out = capsys.readouterr().out
    assert "dam_break3: 1240 particles (1024 fluid + 216 elastic)" in out
    assert '"finite": true' in out
    assert (tmp_path / "frame_00001.ply").exists()
