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


def counts(dim, **kw):
    """A substep's counts as program.substep_counts records them, no
    moving collider evaluated in the kernels."""
    return {"dim": dim, "ce": 1000, "pg": 100, "nj": 10, "njg": 2, "nj2": 1, "nc": 1,
            "n_moving": 0, "npad": 4096, "pchan": 48 if dim == 3 else 32, "wv": 216,
            "group": 256, "n_first": 9, "nb_total": 100, "samples": 50,
            "vertex_floats": 30, "nodes": 5000, "pairs": 50 * 3 ** dim, **kw}


@pytest.mark.parametrize("dim", [2, 3])
def test_substep_bounds_name_the_sources(dim):
    st = counts(dim)
    got = costs.substep_bounds(st)
    kernels = ({"p2g_cdf", "g2p", "update_rows"} if dim == 3
               else {"pcdf2d", "p2g2d", "g2p2d", "update_rows"})
    assert set(got) == kernels | {"permute", "compact", "mesh_cdf"}
    assert all(v > 0 for v in got.values())


# The bounds that the yardstick gave these counts before it counted the
# moving colliders' node-CDF evaluations in kernels A and B.
BEFORE = {
    2: {"permute": 0.00031789850746268656, "compact": 1.4794029850746269e-06,
        "mesh_cdf": 1.2274626865671642e-05, "pcdf2d": 6.35510447761194e-05,
        "p2g2d": 1.552955223880597e-05, "g2p2d": 4.900298507462686e-05,
        "update_rows": 0.00026745313432835824},
    3: {"permute": 0.00047440238805970147, "compact": 1.4794029850746269e-06,
        "mesh_cdf": 1.2394029850746268e-05, "p2g_cdf": 7.160358208955224e-05,
        "g2p": 2.866626865671642e-05, "update_rows": 0.0003931892537313433},
}


@pytest.mark.parametrize("dim", [2, 3])
def test_no_moving_collider_keeps_the_bounds(dim):
    """Counts with no moving collider in the kernels give the bounds bit
    for bit as before; the moving term is 0."""
    assert costs.moving_evals(counts(dim)) == 0
    assert costs.substep_bounds(counts(dim)) == BEFORE[dim]


def test_moving_colliders_add_to_a_and_b():
    """The gathered-hybrid mode's moving colliders: every window node of a
    gate-level-2 job against each, CDF_OPS operations an evaluation, in A
    and B alone."""
    st = counts(3, n_moving=1, nj2=40, wv=576)
    evals = costs.moving_evals(st)
    assert evals == 576 * 40 > 0
    base = costs.a_cost(1000, 100, 10, 2, 1, 576)
    assert costs.a_cost(1000, 100, 10, 2, 1, 576, evals) == (base[0],
                                                              base[1] + evals * costs.CDF_OPS)
    base = costs.g2p_cost(1000, 100, 10, 2, 576)
    assert costs.g2p_cost(1000, 100, 10, 2, 576, evals) == (base[0],
                                                            base[1] + evals * costs.CDF_OPS)
    # A and B are bound by their bytes at most shapes: the bound cannot fall.
    got, still = costs.substep_bounds(st), costs.substep_bounds(dict(st, n_moving=0))
    assert got["p2g_cdf"] >= still["p2g_cdf"] and got["g2p"] >= still["g2p"]
    # With 16 moving colliders (an affinity word's most) they bound A.
    flop_bound = dict(st, ce=10, pg=10, nj=40, njg=40, n_moving=16)
    assert (costs.substep_bounds(flop_bound)["p2g_cdf"]
            > costs.substep_bounds(dict(flop_bound, n_moving=0))["p2g_cdf"])
    assert {k: v for k, v in got.items() if k not in ("p2g_cdf", "g2p")} == {
        k: v for k, v in still.items() if k not in ("p2g_cdf", "g2p")}
