"""The frozen cost functions against the bound ms that PERF.md's table of
kernels gives at the shapes stated there (H100: 3.35 TB/s, 67 TFLOP/s)."""

import pytest

from mpmbench import costs


def npad(n, group):
    return -((n + group) // -2048) * 2048


@pytest.mark.parametrize("name, cost, expected", [
    # Kernel C on the 3D main path: 1,002,001 particles, group 1024, the
    # [48, NPAD] rows; every lane covered.
    ("C 3D", costs.c_cost(costs.C_ROWS_READ_3D, 12, 6, 48, npad(1_002_001, 1024),
                          1_002_001, 6000), 0.1126),
    # C-2D on the 2D column: 490,000 particles, group 512, [32, NPAD] rows.
    ("C 2D", costs.c_cost(costs.C_ROWS_READ_2D, 6, 5, 32, npad(490_000, 512), 490_000,
                          400), 0.0370),
    # Kernel D on the 3D main path: the [48, NPAD] rows permuted.
    ("D 3D", costs.permute_cost(48, npad(1_002_001, 1024)), 0.1162),
])
def test_bound_ms_of_the_table(name, cost, expected):
    assert round(costs.bound(*cost), 4) == expected


def test_bound_takes_the_larger_side():
    assert costs.bound(3.35e9, 0) == pytest.approx(1.0)
    assert costs.bound(0, 67e9) == pytest.approx(1.0)
    assert costs.bound(3.35e9, 2 * 67e9) == pytest.approx(2.0)


@pytest.mark.parametrize("dim", [2, 3])
def test_substep_bounds_name_the_sources(dim):
    st = {"dim": dim, "ce": 1000, "pg": 100, "nj": 10, "njg": 2, "nc": 1, "npad": 4096,
          "pchan": 48 if dim == 3 else 32, "wv": 216, "group": 256, "n_first": 9,
          "nb_total": 100, "samples": 50, "vertex_floats": 30, "nodes": 5000,
          "pairs": 50 * 3 ** dim}
    got = costs.substep_bounds(st)
    kernels = ({"p2g_cdf", "g2p", "update_rows"} if dim == 3
               else {"pcdf2d", "p2g2d", "g2p2d", "update_rows"})
    assert set(got) == kernels | {"permute", "compact", "mesh_cdf"}
    assert all(v > 0 for v in got.values())
