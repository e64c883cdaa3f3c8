"""The port's spatial (x-slab) step against the JAX package's, 2D on the
bounded grid and 3D in the sparse domain, on 2 ranks:

  * tests/test_parallel.py's 2D column (64 x 16 particles, lateral
    velocities of up to 14 m/s, 10 substeps; migration_cap 512);
  * its `_spatial_scene` in the sparse domain (the nominal grid's 10
    x-blocks split in two, the edges owning everything beyond; 12 substeps;
    migration_cap 512, halo_cap 256).

Both packages slab the scene alike, keep every particle, agree by id
within 1e-4 in position and 1e-3 in velocity (the JAX package's own
spatial bounds, tests/test_parallel.py:196-203), count alike, and the
bodies are bit-equal across the ranks (torch_spatial_runs.check_case).
"""

import pytest

from torch_spatial_runs import check_case, run_cases, scene_2d, tp

CASES = {"2d": (scene_2d, 10, False, 512, 1024),
         "sparse": (tp._spatial_scene, 12, True, 512, 256)}


@pytest.fixture(scope="module")
def runs():
    return run_cases(CASES)


def test_spatial_2d_matches_jax(runs):
    check_case(runs["2d"])


def test_spatial_sparse_matches_jax(runs):
    ranks = check_case(runs["sparse"])
    diag = ranks[0]["diags"][-1]
    assert diag["halo_dropped"].sum() == 0 and diag["sparse_n_active"].min() > 0
