"""BENCHMARK.json against the benchmark's contract, every cell's files found
by name, and the harness's imports."""

import ast
import json
import pathlib
import re

import pytest

from mpmbench import compare, run

ROOT = pathlib.Path(__file__).resolve().parents[1]
REPO = ROOT.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
        "per_layer"}


def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_keys_names_and_units():
    b = bench()
    assert set(b) == KEYS
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and (REPO / p).is_dir()
    assert len(b["command"]) <= 32 and all(not w.startswith("/") and ".." not in w
                                           for w in b["command"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("mpmbench/")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    metrics = b["end_to_end"] + b["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
    assert len(json.dumps(b)) < 64 * 1024


def test_check_fits_with_24_cells():
    """A full check of 24 cells fits its 43,200 s."""
    b = bench()
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_cell_files_found_by_name(workload):
    b = bench()
    cell, config, traffic, limits = run.cell_files(b, workload)
    assert config["name"] == cell["config"] and traffic["name"] == cell["traffic"]
    assert {"start_gap", "pos_gap", "vel_gap", "F_gap", "body_gap"} <= set(limits)
    assert set(limits) <= set(compare.NUMBERS)
    for m in run.metric_entries(b, workload, False) + run.metric_entries(b, workload, True):
        assert (ROOT / "metrics" / f"{m['name']}.py").is_file()
    # The entry and each collider kind's parts, found by name.
    assert (ROOT / "entries" / f"{traffic['entry']}.py").is_file()
    assert config["substeps"] % traffic["substeps_per_call"] == 0
    for c in config["colliders"]:
        assert (ROOT / "colliders" / f"{c['kind']}.py").is_file()
        assert (ROOT / "program_colliders" / f"{c['kind']}.py").is_file()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(ROOT.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    """No module of the harness imports JAX or the JAX package (top-level
    names compared whole: wgsparkl_tpu_torch is the port)."""
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "wgsparkl_tpu"}


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py"))
                         + sorted((ROOT / "colliders").glob("*.py"))
                         + [ROOT / "compare.py", ROOT / "costs.py", ROOT / "scene.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_yardstick_imports_no_program(path):
    """The reference, the collider kinds' yardstick parts, the comparison,
    the costs and the generator take nothing of the program."""
    tops = {m.split(".")[0] for m in _imports(path)}
    assert "wgsparkl_tpu_torch" not in tops


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "wgsparkl_tpu_torch_probe", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("y"))
    assert run.forbidden_modules() == ["jaxlib"]
