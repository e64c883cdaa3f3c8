"""The port's sparse domain in the chan-free CDF mode against the JAX
package's: tests/test_sparse_domain.py's sand box lowered onto its floor
and paddle, both sparse and chan-free, held to
tests/torch_port_helpers.compare_states' tolerances (positions 1e-5,
velocities 1e-4, F 1e-4, affinity words exact, bodies 1e-6)."""

from test_torch_sparse_domain import _sparse_box
from torch_port_helpers import compare_states, port_data, run_both
from wgsparkl_tpu_torch.pipeline import step_pallas


def test_sparse_chan_free_matches_jax():
    """The chan-free CDF mode in the sparse domain: the box lowered 4.5
    cells onto its floor and paddle, so that the kernels evaluate every
    collider in-kernel at window nodes placed from the packed keys' block
    coordinates (negative ones included), with gated and ungated jobs.
    Ten substeps, each from the JAX package's state (the lowered lattice
    rests at the Drucker-Prager cone tip, where roundoff grows from substep
    to substep; see test_torch_sparse_overflow.py)."""
    jd = _sparse_box(4.5, chan_free=True)
    assert jd.config.chan_free and jd.config.sparse
    td = port_data(jd, chan_free=True)
    rec = {}
    step_pallas(td.state, td.params, td.config, 1, record=rec)
    live = rec["jobs"]["len"] > 0
    levels = rec["jbody"][live]
    assert rec["chan_free"] and (levels == 2).any() and (levels == 0).any()
    assert (rec["bcells"][live] < 0).any()
    run_both(jd, 10, each=compare_states)
