"""The P2G ablation probe's port (wgsparkl_tpu_torch.ops.ablation) on the
CPU: its input construction against that of tools/ablate_kernels.py
(its lines run at a small N; the script itself needs a TPU), the lists
order of sums, and the full stage's plain version in every core's order
against the JAX package's `pallas_transfer.p2g_tiles` (interpret mode) at
nc = 0, which computes the TPU probe's "full" function."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgsparkl_tpu.grid import GridConfig
from wgsparkl_tpu.ops import pallas_transfer as ptf
from wgsparkl_tpu_torch.ops import ablation
from wgsparkl_tpu_torch.ops import rows as R


_TOOL = pathlib.Path(__file__).resolve().parent.parent / "tools" / "ablate_kernels.py"


def _tpu_probe_inputs(n: int):
    """Lines 13-31 of tools/ablate_kernels.py (from `N = ...` up to the job
    dict), run with N = n."""
    src = _TOOL.read_text()
    body = src[src.index("N = 1_002_001"):src.index("jobs = {")]
    body = re.sub(r"^N = 1_002_001", f"N = {n}", body)
    ns = {"np": np, "ptf": ptf, "GridConfig": GridConfig}
    exec(body, ns)  # noqa: S102 - the TPU probe's own construction
    return ns


@pytest.mark.parametrize("n", [13_001, 40_000])
def test_probe_inputs_are_the_tpu_probes(n):
    ref = _tpu_probe_inputs(n)
    pdata, starts, lens, bcells = ablation.probe_inputs(n=n, device="cpu")
    assert (ref["G"], ref["BY"], ref["MAXJ"], ref["NLIVE"]) == (
        ablation.G, ablation.BY, ablation.MAXJ, ablation.NLIVE)
    assert ref["grid"].cell_width == ablation.CELL_WIDTH
    np.testing.assert_array_equal(pdata.numpy(), ref["pdata"])
    np.testing.assert_array_equal(starts.numpy(), ref["starts"])
    np.testing.assert_array_equal(lens.numpy(), ref["lens"])
    np.testing.assert_array_equal(bcells.numpy(), ref["bcells"])


def test_lists_order_walks_offsets_then_particles():
    """Two jobs of 3 and 2 particles in chunks of 2: pairs (particle,
    offset) come chunk by chunk, offset by offset, particles in order."""
    jid = torch.tensor([0, 0, 0, 1, 1])
    order = R.lists_order(jid, torch.tensor([3, 2]), chunk=2)
    got = [(int(i) // 27, int(i) % 27) for i in order]
    want = ([(p, o) for o in range(27) for p in (0, 1)] + [(2, o) for o in range(27)]
            + [(p, o) for o in range(27) for p in (3, 4)])
    assert got == want


def _small_inputs(affine: bool):
    pdata, starts, lens, bcells = ablation.probe_inputs(
        n=3000, maxj=6, nlive=4, device="cpu")
    if affine:
        # Nonzero affine rows, so that the recombination carries load; of
        # the size a substep gives them (m C with |C| ~ 0.01 per cell), since
        # m v - A x_p and (sum w A) x_node cancel to f32 roundoff of A x at
        # block origins up to 190 cells out.
        rng = np.random.default_rng(1)
        pdata[7:16, :3000] = torch.as_tensor(
            rng.normal(size=(9, 3000)).astype(np.float32) * 0.01)
    return pdata, starts, lens, bcells


@pytest.mark.parametrize("affine", [False, True], ids=["probe", "affine"])
@pytest.mark.parametrize("core", ablation.CORES)
def test_full_plain_matches_jax_p2g_tiles(core, affine):
    pdata, starts, lens, bcells = _small_inputs(affine)
    out = ablation.p2g_ablation(pdata, starts, lens, bcells, stage="full", core=core)
    _, _, wpad = R.window_geom(ablation.BY)
    grid = GridConfig(shape=(108, 112, 108), cell_width=ablation.CELL_WIDTH,
                      origin_cell=(-2, -2, -2))
    ref, imp = ptf.p2g_tiles(
        jnp.asarray(pdata.numpy()), jnp.zeros((1, wpad, 4), jnp.float32),
        jnp.zeros((32, 128), jnp.float32),
        {"start": jnp.asarray(starts.numpy()), "len": jnp.asarray(lens.numpy())},
        jnp.asarray(bcells.numpy()), grid, ablation.G, 0, None, by=ablation.BY)
    ref = np.asarray(ref)
    assert float(np.abs(ref[..., 3]).sum()) > 0.0 and not np.asarray(imp).any()
    # Sums over a job's particles in another order than the JAX kernel's
    # dense window x group product: f32 roundoff relative to the largest
    # entry (the kernel-A precedent).
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-6 * np.abs(ref).max())


def test_full_plain_cores_differ_only_in_order():
    """Both orders sum the same pairs: within f32 roundoff of each other,
    masses (sums of weights times 1) included."""
    inputs = _small_inputs(True)
    scan = ablation.p2g_ablation(*inputs, core="scan")
    lists = ablation.p2g_ablation(*inputs, core="lists")
    np.testing.assert_allclose(lists.numpy(), scan.numpy(), rtol=0,
                               atol=1e-6 * float(scan.abs().max()))
    with pytest.raises(ValueError):
        ablation.p2g_ablation(*inputs, stage="accumulate")


def test_pairs_plain_is_the_lists_plain():
    """The pairs core walks two z-neighbour nodes at once, each in its own
    lists order: its plain version is the lists core's, bit for bit."""
    inputs = _small_inputs(True)
    pairs = ablation.p2g_ablation(*inputs, core="pairs")
    assert float(pairs[..., 3].sum()) > 0.0
    assert torch.equal(pairs, ablation.p2g_ablation(*inputs, core="lists"))
