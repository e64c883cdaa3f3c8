"""The port's spatial (x-slab) step against the JAX package's, 3D on the
bounded grid, on 2 ranks: tests/test_parallel.py's `_spatial_scene` (a
24 x 8 x 8 elastic lattice with lateral velocities of up to 12 m/s, so that
particles cross the slab boundary, over a floor; 10 x-blocks, 5 a slab).

Both packages slab the scene alike (bit for bit), keep every particle, and
agree by id within the JAX package's own spatial bounds, 1e-4 in position
and 1e-3 in velocity after 12 substeps (tests/test_parallel.py:196-203);
the counters of every rank equal JAX's, with migration_cap 512 (nothing
dropped) and 8 (tests/test_parallel.py:270-296: hundreds of crossers,
dropped); the bodies are bit-equal across the ranks.  The port's ranks run
on gloo through wgsparkl_tpu_torch/parallel/launch.py (torch_spatial_runs).
"""

import numpy as np
import pytest

from torch_spatial_runs import check_case, run_cases, tp
from wgsparkl_tpu_torch.pipeline import StepDiag

CASES = {"bounded": (tp._spatial_scene, 12, False, 512, 1024),
         "migration_cap_8": (tp._spatial_scene, 8, False, 8, 1024)}


@pytest.fixture(scope="module")
def runs():
    return run_cases(CASES)


def test_spatial_3d_matches_jax(runs):
    """No fault counter set on any rank; migrants were shipped."""
    ranks = check_case(runs["bounded"])
    diag = ranks[0]["diags"][-1]
    assert not any(np.any(diag[k]) for k in StepDiag.FAULTS)
    assert diag["migrated"].sum() > 0


def test_spatial_diag_counts_dropped_migrants_like_jax(runs):
    """migration_cap 8: the dropped movers of each rank equal JAX's (and
    there are some); positions stay finite."""
    run = runs["migration_cap_8"]
    md = run["ranks"][0]["diags"][-1]["migration_dropped"]
    assert md.shape == (2,) and md.sum() > 0, md
    np.testing.assert_array_equal(md, np.asarray(run["jax_diag"].migration_dropped))
    for r in run["ranks"]:
        assert np.isfinite(r["states"][-1].particles.pos).all()
