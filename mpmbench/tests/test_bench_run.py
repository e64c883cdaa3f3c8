"""A whole run of each small cell on the CPU with the chip check skipped:
sound, it is correct; with the timed path broken underneath
(MpmPipeline.step returning the state unchanged, leaving half the particles
as they were, or moving one particle), `correct` comes out false.  A cell
whose traffic names another entry runs it.  And the command without a card,
or a run in which JAX was loaded after the window, fails with no result."""

import dataclasses
import io
import json
import sys
import types

import pytest
import torch

from mpmbench import run
from mpmbench.tests.bench_small import small_files

CELLS = ("cut2.frame15", "hf3.frame20")


def _run(workload, seed=2 ** 31 + 4242, files=None):
    torch.set_num_threads(4)
    return run.run_cell(run.load_benchmark(), workload, seed, 0.5, False, device="cpu",
                        files=files or small_files(workload, episode=3))


def _broken(kind):
    from wgsparkl_tpu_torch.pipeline import MpmPipeline, StepDiag

    step = MpmPipeline.step

    def broken(self, data, num_substeps=1, params=None):
        if kind == "unchanged":
            return StepDiag.zeros(data.state.particles.pos.device)
        before = data.state.particles
        diag = step(self, data, num_substeps, params)
        p = data.state.particles
        if kind == "half":
            row = torch.empty_like(before.ids)
            row[before.ids.long()] = torch.arange(len(row), dtype=row.dtype)
            back = row[p.ids.long()].long()
            odd = (p.ids % 2) == 1
            fields = {}
            for f in ("pos", "vel", "def_grad", "affine"):
                new, old = getattr(p, f), getattr(before, f)[back]
                shape = (-1,) + (1,) * (new.dim() - 1)
                fields[f] = torch.where(odd.view(shape), old, new)
            data.state.particles = dataclasses.replace(p, **fields)
        else:
            pos = p.pos.clone()
            pos[len(pos) // 2, 0] += 0.01 * data.config.grid.cell_width
            data.state.particles = dataclasses.replace(p, pos=pos)
        return diag

    return broken


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert {"substeps_per_s", "frame_ms_p95", "setup_s"} <= set(res["metrics"])


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("kind", ("unchanged", "half", "altered"))
def test_broken_step_is_not_correct(monkeypatch, workload, kind):
    from wgsparkl_tpu_torch.pipeline import MpmPipeline

    monkeypatch.setattr(MpmPipeline, "step", _broken(kind))
    res = _run(workload)
    assert not res["correct"], res["checks"]


def test_one_substep_entry_is_correct():
    """The traffic's entry is found by name: the one-substep entry, called
    once a substep, gives a correct run."""
    cell, cfg, traffic, limits = small_files(CELLS[0], episode=3)
    traffic = dict(traffic, entry="substep_pallas", substeps_per_call=1)
    res = _run(CELLS[0], files=(cell, cfg, traffic, limits))
    assert res["correct"], res["checks"]


def test_jax_loaded_after_the_window_no_result(monkeypatch):
    """A metric's reader that loads JAX: the run ends non-zero and prints
    nothing."""
    read = run.read_metric

    def loads_jax(name, ctx):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return read(name, ctx)

    monkeypatch.setattr(run, "read_metric", loads_jax)
    out = io.StringIO()
    with pytest.raises(SystemExit) as ended:
        run.emit(_run(CELLS[0]), out)
    assert ended.value.code != 0 and out.getvalue() == ""


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_short_run_on_the_card(cuda_card, capsys):
    assert run.main(["--workload", CELLS[0], "--seed", "7", "--seconds", "2"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
