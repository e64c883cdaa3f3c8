"""The window scatter as a pull (ops/blocked.scatter_tiles_pull, kernel
scatter_pull, csrc/scatter_pull.cu) against the accumulating scatter of
every job slot (ops/blocked.add_rows into zeros), bit for bit on every
grid row, the ghost block's included.

  * CPU (tier 1): the plain version on random 2D and 3D job tables at by 4
    and by 8, and at by 3, 5 and 7 (blocks of 48, 80 and 112 nodes: the
    kernel's last warp partial): dead slots, blocks of several jobs, jobs
    past max_jobs, live blocks on the high boundary whose windows leave the
    grid (so the ghost sums live tiles), grids one block thick on an axis,
    and an empty grid.
    The tiles' magnitudes spread over eight decades, so another order of
    the adds changes the sums; the grid starts as NaN, so every row must
    be written.  The substep's dispatch: the CPU adds into zeros.
  * Card (marked `cuda`; skip without one): the kernel against add_rows on
    the device (index_put_(accumulate=True), whose order it follows) and
    against the plain version on the same tables, twice for the same bits;
    and on a recorded full-size substep of each benchmark cell's
    configuration.  Run them on a GPU host with
    `python -m pytest --noconftest tests/test_torch_scatter_pull.py -m cuda`.
"""

import zlib

import numpy as np
import pytest
import torch

from wgsparkl_tpu_torch.ops import blocked as bk

# (dim, by, nb, group, max_jobs as a share of the jobs needed, case)
CASES = [
    (3, 4, (3, 4, 2), 4, 2.0, "dead_slots"),
    (3, 4, (3, 4, 2), 4, 0.6, "overflow"),
    (3, 4, (2, 1, 3), 8, 1.5, "thin_axis"),
    (3, 8, (2, 3, 2), 4, 2.0, "dead_slots"),
    (3, 8, (2, 3, 2), 4, 0.7, "overflow"),
    (3, 5, (3, 3, 2), 4, 2.0, "dead_slots"),
    (3, 3, (2, 3, 3), 4, 0.7, "overflow"),
    (3, 7, (3, 1, 2), 8, 1.5, "thin_axis"),
    (2, 4, (4, 3), 4, 2.0, "dead_slots"),
    (2, 4, (4, 3), 4, 0.6, "overflow"),
    (2, 4, (1, 5), 8, 1.5, "thin_axis"),
    (3, 4, (3, 2, 2), 4, 1.0, "empty"),
    (2, 4, (3, 3), 4, 1.0, "empty"),
]
IDS = [f"{d}d_by{by}_{'x'.join(map(str, nb))}_{case}" for d, by, nb, _, _, case in CASES]


def _table(dim, by, nb, group, share, case, seed, device="cpu"):
    """(tiles [J, wpad, 8], block, cum, src, jobs) of a random job table:
    particles in about half the blocks, every block on the high boundary
    among them, some blocks holding several jobs; off-grid and padding
    lanes sorted last as the substep sorts them.  Dead slots' tiles are
    +0.0, as kernels A, F and H write them."""
    rng = np.random.default_rng(seed)
    nbt = int(np.prod(nb))
    st = bk.storage_strides(nb)
    coords = np.stack(np.unravel_index(np.arange(nbt), nb), -1)
    flat = (coords * np.asarray(st)).sum(-1)
    edge = (coords == np.asarray(nb) - 1).any(-1)
    if case == "empty":
        ids = np.full(50, nbt + 1)
    else:
        pick = edge | (rng.random(nbt) < 0.5)
        counts = np.where(pick, rng.integers(1, 3 * group + 1, nbt), 0)
        ids = np.concatenate([np.repeat(flat, counts), np.full(7, nbt),
                              np.full(9, nbt + 1)])
    sids = torch.as_tensor(np.sort(ids).astype(np.int32))
    needed = int(bk.build_jobs(sids, nbt, group, 1)["needed"])
    max_jobs = max(8, int(share * needed))
    jobs = bk.build_jobs(sids, nbt, group, max_jobs)
    if case == "overflow":
        assert needed > max_jobs
    if case == "empty":
        assert needed == 0
    wvol = int(np.prod(bk.window_shape(dim, by)))
    wpad = -(-wvol // 8) * 8
    mag = 10.0 ** rng.uniform(-4.0, 4.0, (max_jobs, wpad, 8))
    tiles = torch.as_tensor((rng.standard_normal((max_jobs, wpad, 8)) * mag)
                            .astype(np.float32))
    tiles[jobs["len"] == 0] = 0.0
    src = bk.window_sources(jobs["block"], nb, by)
    return ([x.to(device) for x in (tiles, jobs["block"], jobs["cum"], src)]
            + [jobs, max_jobs])


def _seed(*case):
    return zlib.crc32(repr(case).encode())


def _bits(x):
    return x.contiguous().view(torch.int32)


def _reference(tiles, src, nbt, bsd, c, reverse=False):
    """add_rows of every slot's window into zeros, the slots in slot order
    (or reversed)."""
    grid = torch.zeros((nbt + 1, bsd, c), dtype=torch.float32, device=tiles.device)
    if reverse:
        tiles, src = tiles.flip(0), src.flip(0)
    return bk.scatter_tiles(grid, tiles, src)


@pytest.mark.parametrize("dim,by,nb,group,share,case", CASES, ids=IDS)
def test_plain_pull_equals_add_rows(dim, by, nb, group, share, case):
    chans = dim + 1     # momentum and mass
    tiles, block, cum, src, jobs, max_jobs = _table(dim, by, nb, group, share, case,
                                                    seed=_seed(dim, by, nb, case))
    nbt, bsd = int(np.prod(nb)), int(np.prod(bk.block_shape(dim, by)))
    ref = _reference(tiles, src, nbt, bsd, chans)
    grid = torch.full((nbt + 1, bsd, chans), float("nan"))
    out = bk.scatter_tiles_pull_plain(grid, tiles, block, cum, nb, by)
    assert out is grid
    assert torch.equal(_bits(out), _bits(ref))
    live = int((jobs["len"] > 0).sum())
    if case == "empty":
        assert live == 0 and not ref.any()
        return
    # Live tiles on the high boundary reach the ghost; so does the order.
    assert live == min(int(jobs["needed"]), max_jobs) and ref[nbt].abs().sum() > 0
    rev = _reference(tiles, src, nbt, bsd, chans, reverse=True)
    assert not torch.equal(_bits(rev), _bits(ref))


def test_octant_order_is_ascending_source():
    """Each destination block's octants come in ascending source id, as
    the slots of the sources' jobs do."""
    for nb in [(3, 4, 2), (2, 1, 3), (5, 5, 5), (4, 3), (1, 5)]:
        st = bk.storage_strides(nb)
        offs = [sum(e[a] * st[a] for a in range(len(nb))) for e in bk._octant_order(nb)]
        assert offs == sorted(offs, reverse=True)
    # The kernel's fixed orders (csrc/scatter_pull.cu ORDER3, ORDER2).
    assert [int(np.ravel_multi_index(e, (2, 2, 2)))
            for e in bk._octant_order((5, 5, 5))] == [7, 5, 6, 4, 3, 1, 2, 0]
    assert [int(np.ravel_multi_index(e, (2, 2))) for e in bk._octant_order((4, 3))] == [
        3, 2, 1, 0]


@pytest.mark.parametrize("dim", [2, 3])
def test_cpu_substep_adds_into_zeros(monkeypatch, dim):
    """On the CPU the substep's scatter stays add_rows (index_add_) into a
    zeroed grid: the pull never runs there."""
    from wgsparkl_tpu_torch import pipeline, scenes

    calls = []
    monkeypatch.setattr(bk, "scatter_tiles_pull", lambda *a: calls.append(a))
    if dim == 3:
        data = scenes.sand_box_3d(nxz=4, ny=4, device="cpu", with_paddle=False)
    else:
        data = scenes.sand_column_2d(nx=16, ny=16, device="cpu")
    rec = {}
    pipeline.step_pallas(data.state, data.params, data.config, 1, record=rec)
    assert not calls and "cum" in rec
    cfg = data.config
    nb = bk.num_blocks(cfg.grid, cfg.by)
    assert rec["cum"].shape == (int(np.prod(nb)),)
    assert int(rec["cum"][-1]) == int((rec["jobs"]["len"] > 0).sum())


# ---------------------------------------------------------------- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("dim,by,nb,group,share,case", CASES, ids=IDS)
def test_card_kernel_equals_add_rows(dim, by, nb, group, share, case):
    dev = _card()
    chans = dim + 1
    tiles, block, cum, src, _, _ = _table(dim, by, nb, group, share, case,
                                          seed=_seed(dim, by, nb, case),
                                          device=dev)
    nbt, bsd = int(np.prod(nb)), int(np.prod(bk.block_shape(dim, by)))
    ref = _reference(tiles, src, nbt, bsd, chans)
    before = bk.scatter_tiles_pull.launches
    outs = []
    for _ in range(2):
        grid = torch.full((nbt + 1, bsd, chans), float("nan"), device=dev)
        outs.append(bk.scatter_tiles_pull(grid, tiles, block, cum, nb, by))
    torch.cuda.synchronize()
    assert bk.scatter_tiles_pull.launches == before + 2
    plain = bk.scatter_tiles_pull_plain(torch.empty_like(ref), tiles, block, cum, nb, by)
    for out in outs:
        assert torch.equal(_bits(out), _bits(ref))
        assert torch.equal(_bits(out), _bits(plain))


def _cell_record(cell):
    """A recorded substep of the cell's configuration at full size on the
    card, after two frames of its episode."""
    from mpmbench import program, run, scene
    from wgsparkl_tpu_torch.pipeline import step_pallas

    _, cfg, traffic, _ = run.cell_files(run.load_benchmark(), cell)
    inputs = scene.make(cfg, traffic, 2 ** 31 + 24)
    data = program.build(inputs, "cuda")
    state = data.state
    for _ in range(2):
        state = step_pallas(state, data.params, data.config, inputs.substeps)
    rec = {}
    step_pallas(state, data.params, data.config, 1, record=rec)
    return data.config, rec


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cut2.frame15", "hf3.frame20", "sand3_1m.frame20"])
def test_card_full_size_substep(cell):
    _card()
    cfg, rec = _cell_record(cell)
    nb = bk.num_blocks(cfg.grid, cfg.by)
    nbt, bsd = int(np.prod(nb)), int(np.prod(bk.block_shape(cfg.grid.dim, cfg.by)))
    chans = 4 if cfg.grid.dim == 3 else 3
    mm, block, cum = rec["mm"], rec["jobs"]["block"], rec["cum"]
    ref = _reference(mm, rec["src"], nbt, bsd, chans)
    grid = torch.full_like(ref, float("nan"))
    out = bk.scatter_tiles_pull(grid, mm, block, cum, nb, cfg.by)
    assert torch.equal(_bits(out), _bits(ref))
    assert int((rec["jobs"]["len"] > 0).sum()) == min(int(cum[-1]), cfg.max_jobs) > 0
