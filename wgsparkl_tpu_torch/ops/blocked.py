"""Block-grid addressing, sort keys, the sort, job tables, window weights
and window tile moves (port of wgsparkl_tpu/ops/blocked.py; the sparse
domain's keys and tables at the end).

Blocks are 4 x by x 4 nodes in 3D, 8 x 8 in 2D; flat block ids enumerate
blocks gravity (y) fastest ((x, z, y) order in 3D, (x, y) in 2D, x
slowest in both) and double as the particle sort keys.  Grid storage is
[NB + 1, bsd, C] (bsd nodes per block): slot NB is the ghost block that dead
jobs and out-of-range window neighbours read and write.  The TPU's one-hot
matmul tile moves (banded slabs, two-level dispatch, Dekker selection
splits) become a plain indexed gather and an ordered row add (add_rows) here.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from wgsparkl_tpu_torch import _cuda
from wgsparkl_tpu_torch.grid import GridConfig
from wgsparkl_tpu_torch.math import div
from wgsparkl_tpu_torch.ops.kernel import axis_weights


BLOCK2D = 8   # nodes per axis of a 2D block
BLOCK3D = 4   # 3D: 4 x 4 x 4 at by 4


def block_size(dim: int) -> int:
    """Nodes per axis of an isotropic block (4^3 in 3D, 8^2 in 2D)."""
    return BLOCK3D if dim == 3 else BLOCK2D


def window_size(dim: int) -> int:
    """Nodes per axis of an isotropic block's window (a 2-node halo on the
    high side)."""
    return block_size(dim) + 2


def block_shape(dim: int, by: int = 4) -> Tuple[int, ...]:
    return (BLOCK2D, BLOCK2D) if dim == 2 else (4, by, 4)


def window_shape(dim: int, by: int = 4) -> Tuple[int, ...]:
    """A block plus a 2-node halo on the high side of each axis."""
    return tuple(b + 2 for b in block_shape(dim, by))


def storage_strides(nb: Tuple[int, ...]) -> Tuple[int, ...]:
    """Per-axis strides of the flat block id, y fastest: (x, y) order in
    2D, (x, z, y) in 3D."""
    if len(nb) == 2:
        return (nb[1], 1)
    return (nb[1] * nb[2], 1, nb[1])


def num_blocks(cfg: GridConfig, by: int = 4) -> Tuple[int, ...]:
    bsh = block_shape(cfg.dim, by)
    if any(s % b for s, b in zip(cfg.shape, bsh)):
        raise ValueError(f"grid shape {cfg.shape} is not whole {bsh} blocks")
    return tuple(s // b for s, b in zip(cfg.shape, bsh))


def particle_block_ids_ch(pch, cfg: GridConfig, by: int = 4):
    """Flat home-block id per particle (block of the stencil base cell,
    round(p / h) - 1); out-of-grid lanes get NB (the overflow bucket).
    pch: d position channels [N]."""
    bsh = block_shape(len(pch), by)
    nb = num_blocks(cfg, by)
    st = storage_strides(nb)
    flat, ok = None, None
    for a in range(len(pch)):
        base = torch.round(div(pch[a], cfg.cell_width)).to(torch.int32) - 1
        blk = torch.div(base - int(cfg.origin_cell[a]), bsh[a],
                        rounding_mode="floor")
        oka = (blk >= 0) & (blk < nb[a])
        ok = oka if ok is None else ok & oka
        flat = blk * st[a] if flat is None else flat + blk * st[a]
    return torch.where(ok, flat, int(np.prod(nb))).to(torch.int32)


def particle_sort_keys_ch(pch, cfg: GridConfig, by: int = 4):
    """The gravity-fastest sort key: the flat block id
    (particle_block_ids_ch)."""
    return particle_block_ids_ch(pch, cfg, by)


def particle_block_ids(pos, cfg: GridConfig, by: int = 4):
    """(flat home-block id [N] int32, block coordinates [N, d] int32) of
    particles at pos [N, d]: the block of the stencil base cell round(p /
    h) - 1; particles off the grid get id NB (the overflow bucket, sorted
    last).  sort_by_block sorts a state by the ids; the substeps sort the
    row matrix (pipeline.sort_rows_by_block)."""
    d = pos.shape[-1]
    bsh = torch.tensor(block_shape(d, by), dtype=torch.int32, device=pos.device)
    origin = torch.tensor(cfg.origin_cell, dtype=torch.int32, device=pos.device)
    base = torch.round(div(pos, cfg.cell_width)).to(torch.int32) - 1
    blk = torch.div(base - origin, bsh, rounding_mode="floor").to(torch.int32)
    return particle_block_ids_ch([pos[:, a] for a in range(d)], cfg, by), blk


def _tree_map(fn, tree):
    """fn on every tensor leaf of nested dataclasses, dicts, tuples and
    lists; a Models' material table (indexed by material, not particle)
    and every non-tensor leaf stay."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: (getattr(tree, f.name) if f.name == "mat_table"
                     else _tree_map(fn, getattr(tree, f.name)))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def sort_by_block(state_arrays, block_ids):
    """Sort a tree of [N, ...] tensors (e.g. (particles, models)) stably by
    block id: (sorted tree, sorted_ids, perm int32) (the reference's
    finalize_particles_sort, sort.wgsl:117-137)."""
    sorted_ids, perm = torch.sort(block_ids, stable=True)
    idx = perm.to(torch.int64)
    return _tree_map(lambda x: x[idx], state_arrays), sorted_ids, perm.to(torch.int32)


def key_to_block(key, nb, dim: int):
    """Sort key -> storage block id: the identity (storage is y-fastest)."""
    return key


def build_jobs(sorted_ids, nb_total: int, group: int, max_jobs: int):
    """Job table from sorted block ids: dict of [max_jobs] int32 tensors
    block (flat id; NB for dead jobs), start (first sorted rank), len
    (<= group; 0 for dead jobs), plus needed (0-d: jobs the substep asked
    for; > max_jobs means the tail was dropped) and cum ([NB] int32, the
    inclusive sum of jobs per block: block s owns the slots [cum[s - 1],
    min(cum[s], max_jobs)))."""
    from wgsparkl_tpu_torch.ops.compact import compact_flagged

    dev = sorted_ids.device
    n = sorted_ids.shape[0]
    is_first = torch.ones(n, dtype=torch.bool, device=dev)
    is_first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    pad_key = nb_total + 2
    # Boundaries are at most the distinct keys 0..nb_total+1 and at most n,
    # so they always fit kmax and the compaction never overflows.
    kmax = min(nb_total + 3, n)
    if max(pad_key, n) >= 2 ** 24:
        raise ValueError("block keys and ranks must stay below 2^24")
    cvals, _ = compact_flagged(
        torch.clamp(sorted_ids, max=pad_key - 1).to(torch.float32)[None, :],
        is_first, kmax)
    bkey = torch.clamp(cvals[0], max=float(pad_key)).to(torch.int32)
    brank = torch.clamp(cvals[1], max=float(n)).to(torch.int32)
    q = torch.arange(nb_total + 1, dtype=torch.int32, device=dev)
    edges = brank[torch.searchsorted(bkey, q).clamp(0, kmax - 1)]
    edges = torch.where(q > sorted_ids[-1], n, edges).to(torch.int32)
    first = edges[:nb_total]
    counts = edges[1:] - first
    jobs_per_block = (counts + (group - 1)) // group
    cum_jobs = torch.cumsum(jobs_per_block, 0, dtype=torch.int32)
    total_jobs = cum_jobs[-1]
    job_idx = torch.arange(max_jobs, dtype=torch.int32, device=dev)
    jb = torch.searchsorted(cum_jobs, job_idx, right=True).to(torch.int32)
    live = job_idx < total_jobs
    jb_safe = torch.where(live, jb, 0)
    prev_cum = torch.where(jb_safe > 0,
                           cum_jobs[torch.clamp(jb_safe - 1, min=0)], 0)
    rank = job_idx - prev_cum
    start = first[jb_safe] + rank * group
    length = torch.clamp(counts[jb_safe] - rank * group, 0, group)
    length = torch.where(live, length, 0)
    return {
        "block": torch.where(live, jb_safe, nb_total).to(torch.int32),
        "start": start.to(torch.int32),
        "len": length.to(torch.int32),
        "needed": total_jobs,
        "cum": cum_jobs,
    }


def block_coords_of(flat, nb):
    """Flat block id -> [J, d] coords (overflow ids wrap; callers mask)."""
    st = storage_strides(nb)
    return torch.stack([torch.remainder(torch.div(flat, st[a],
                                                  rounding_mode="floor"),
                                        nb[a]) for a in range(len(nb))], dim=-1)


@functools.lru_cache(maxsize=None)
def _cell_tables(bsh: Tuple[int, ...], origin: Tuple[int, ...],
                 device: torch.device):
    return (torch.tensor(bsh, dtype=torch.int32, device=device),
            torch.tensor(origin, dtype=torch.int32, device=device))


def block_origin_cells(flat, nb, by: int, origin_cell):
    """Flat block id -> [J, d] int32 grid cell of the block's first node."""
    bsh, origin = _cell_tables(block_shape(len(nb), by),
                               tuple(int(o) for o in origin_cell), flat.device)
    return (block_coords_of(flat, nb) * bsh + origin).to(torch.int32)


def window_weights(pos, blk_coords, cfg: GridConfig, by: int = 4):
    """One job's window weight matrix rows: (w_flat [..., prod(WSH)], the
    base cell within the window base_local [..., d] int32, the fractional
    offset xfrac [..., d]) of particles at pos [..., d] in their home
    blocks blk_coords [..., d]; the window's nodes row-major."""
    d = pos.shape[-1]
    dev = pos.device
    bsh = torch.tensor(block_shape(d, by), dtype=torch.int32, device=dev)
    wsh = window_shape(d, by)
    u = div(pos, cfg.cell_width)
    base = torch.round(u).to(torch.int32) - 1
    xfrac = u - base.to(pos.dtype)
    origin = torch.tensor(cfg.origin_cell, dtype=torch.int32, device=dev)
    base_local = torch.minimum(torch.clamp(base - origin - blk_coords * bsh, min=0),
                               bsh - 1).to(torch.int32)
    rows = []
    for a in range(d):
        wa = axis_weights(xfrac[..., a])
        rel = (torch.arange(wsh[a], dtype=torch.int32, device=dev)
               - base_local[..., a, None])
        row = torch.zeros(rel.shape, dtype=pos.dtype, device=dev)
        for k in range(3):
            row = torch.where(rel == k, wa[k][..., None], row)
        rows.append(row)
    if d == 2:
        w = rows[0][..., :, None] * rows[1][..., None, :]
    else:
        w = (rows[0][..., :, None, None] * rows[1][..., None, :, None]
             * rows[2][..., None, None, :])
    return w.reshape(*pos.shape[:-1], int(np.prod(wsh))), base_local, xfrac


@functools.lru_cache(maxsize=None)
def window_node_offsets(dim: int, by: int = 4) -> np.ndarray:
    """[prod(WSH), d] int32 offsets of the window nodes from the block's
    first node, row-major."""
    grids = np.meshgrid(*[np.arange(w) for w in window_shape(dim, by)], indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1).astype(np.int32)


def window_node_positions(blk_coords, cfg: GridConfig, by: int = 4):
    """[..., prod(WSH), d] world positions of the window nodes of the blocks
    at blk_coords [..., d]."""
    d = cfg.dim
    dev = blk_coords.device
    bsh = torch.tensor(block_shape(d, by), dtype=torch.int32, device=dev)
    offs = torch.as_tensor(window_node_offsets(d, by), device=dev)
    origin = torch.tensor(cfg.origin_cell, dtype=torch.int32, device=dev)
    cell = blk_coords[..., None, :] * bsh + origin + offs
    return cell.to(torch.float32) * cfg.cell_width


def octant_flat_offsets(nb: Tuple[int, ...]) -> Tuple[int, ...]:
    """Flat block-id offset of each {0,1}^d neighbour (np.ndindex order)."""
    st = storage_strides(nb)
    return tuple(int(sum(e[a] * st[a] for a in range(len(nb))))
                 for e in np.ndindex(*((2,) * len(nb))))


@functools.lru_cache(maxsize=None)
def neighbor_block_table(nb: Tuple[int, ...]) -> np.ndarray:
    """[NB + 1, 2^d] flat ids of each block's {0,1}^d neighbours, octants
    in np.ndindex order; out-of-range neighbours and the overflow row -> NB."""
    d = len(nb)
    st = storage_strides(nb)
    mesh = np.stack(np.meshgrid(*[np.arange(s) for s in nb], indexing="ij"),
                    -1).reshape(-1, d)
    order = np.argsort(sum(mesh[:, a] * st[a] for a in range(d)))
    coords = mesh[order]
    out = []
    for e in np.ndindex(*((2,) * d)):
        nbr = coords + np.asarray(e)
        ok = np.all(nbr < np.asarray(nb), axis=-1)
        out.append(np.where(ok, sum(nbr[:, a] * st[a] for a in range(d)),
                            np.prod(nb)))
    table = np.stack(out, axis=-1).astype(np.int64)
    return np.concatenate([table, np.full((1, 2 ** d), np.prod(nb), np.int64)])


@functools.lru_cache(maxsize=None)
def window_map(by: int, dim: int = 3):
    """(octant [wvol], cell [wvol]) of each window node, window nodes in
    row-major order: which {0,1}^d neighbour block it lies in (np.ndindex
    order) and its row-major cell index there."""
    bsh = block_shape(dim, by)
    octs, cells = [], []
    for w in np.ndindex(*window_shape(dim, by)):
        e = [int(w[a] >= bsh[a]) for a in range(dim)]
        c = [w[a] - e[a] * bsh[a] for a in range(dim)]
        octs.append(int(np.ravel_multi_index(e, (2,) * dim)))
        cells.append(int(np.ravel_multi_index(c, bsh)))
    return np.asarray(octs, np.int64), np.asarray(cells, np.int64)


@functools.lru_cache(maxsize=None)
def _window_tables(nb: Tuple[int, ...], by: int, device: torch.device):
    """neighbor_block_table(nb) and window_map(by, d) as tensors on
    `device`, copied there once."""
    octs, cells = window_map(by, len(nb))
    return (torch.as_tensor(neighbor_block_table(nb), device=device),
            torch.as_tensor(octs, device=device),
            torch.as_tensor(cells, device=device))


def window_sources(job_block, nb, by: int):
    """[J, wvol] flat (block * bsd + cell) grid row of every window node."""
    nbr, octs, cells = _window_tables(tuple(nb), by, job_block.device)
    blk = nbr[job_block.to(torch.int64)][:, octs]
    bsd = int(np.prod(block_shape(len(nb), by)))
    return blk * bsd + cells[None, :]


def add_rows(dst, index, src):
    """dst[index[i]] += src[i], the rows of each destination added in the
    order of i on every device: index_add_ on the CPU, an accumulating
    index_put_ (sort-based, deterministic) on CUDA, where index_add_ adds
    in no fixed order."""
    if dst.device.type == "cpu":
        dst.index_add_(0, index, src)
    else:
        dst.index_put_((index,), src, accumulate=True)
    return dst


def gather_tiles(grid_blocks, src, wpad: int, cpad: int):
    """Window tiles [J, wpad, cpad] from grid rows [NB + 1, bsd, C] (pad
    rows and channels past C are zero)."""
    c = grid_blocks.shape[-1]
    flat = grid_blocks.reshape(-1, c)
    j, wvol = src.shape
    out = torch.zeros((j, wpad, cpad), dtype=grid_blocks.dtype,
                      device=grid_blocks.device)
    out[:, :wvol, :c] = flat[src]
    return out


def scatter_tiles(grid_blocks, tiles, src):
    """Add the window tiles [J, wpad, >=C] into grid rows [NB + 1, bsd, C],
    each row's tiles in job order."""
    c = grid_blocks.shape[-1]
    j, wvol = src.shape
    add_rows(grid_blocks.reshape(-1, c), src.reshape(-1),
             tiles[:, :wvol, :c].reshape(-1, c))
    return grid_blocks


def _octant_order(nb: Tuple[int, ...]):
    """The {0,1}^d octants in ascending source block id of a destination
    block (descending flat offset); the ties lie off the grid."""
    st = storage_strides(nb)
    return sorted(np.ndindex(*((2,) * len(nb))),
                  key=lambda e: -sum(e[a] * st[a] for a in range(len(nb))))


def scatter_tiles_pull_plain(grid_blocks, tiles, block, cum, nb, by: int):
    """Kernel scatter_pull's plain version: grid_blocks [NB + 1, bsd, C]
    written row by row from the window tiles [J, wpad, >= C] of the job
    table's block [J] and cum [NB] (inclusive jobs per block; slots past J
    dropped), each node's tiles summed from +0.0 in the order an
    accumulating scatter of every slot (add_rows) adds them.  Grid block
    B's node c: the octants e of the sources B - e on the grid in ascending
    source id, each source's jobs in slot order, where e * bsh + c is in
    the window.  The ghost NB: the live jobs in slot order, each one's
    octants that leave the grid in octant order; dead slots' tiles (+0.0)
    change no such sum and are skipped."""
    nb = tuple(int(n) for n in nb)
    d, dev, c = len(nb), grid_blocks.device, grid_blocks.shape[-1]
    bsh, wsh = np.asarray(block_shape(d, by)), np.asarray(window_shape(d, by))
    nbt, maxj = int(np.prod(nb)), tiles.shape[0]
    cells = np.asarray(list(np.ndindex(*bsh)))                        # [bsd, d]
    wst = np.asarray([int(np.prod(wsh[a + 1:])) for a in range(d)])

    def window_rows(e):
        pos = cells + np.asarray(e) * bsh
        inwin = (pos < wsh).all(-1)
        return (torch.as_tensor(np.where(inwin, pos @ wst, 0), device=dev),
                torch.as_tensor(inwin, device=dev))

    acc = torch.zeros((nbt + 1, cells.shape[0], c), dtype=torch.float32, device=dev)
    hi_all = torch.clamp(cum.to(torch.int64), max=maxj)
    lo_all = torch.cat([hi_all.new_zeros(1), hi_all[:-1]])
    coords = block_coords_of(torch.arange(nbt, device=dev), nb)
    st = storage_strides(nb)
    for e in _octant_order(nb):
        on = (coords >= torch.as_tensor(e, device=dev)).all(-1)
        s = torch.where(on, torch.arange(nbt, device=dev)
                        - sum(e[a] * st[a] for a in range(d)), 0)
        lo = torch.where(on, lo_all[s], 0)
        hi = torch.where(on, hi_all[s], 0)
        w, inwin = window_rows(e)
        for r in range(int((hi - lo).max())):
            j = lo + r
            v = tiles[torch.clamp(j, max=maxj - 1)][:, w, :c]
            keep = (j < hi)[:, None, None] & inwin[None, :, None]
            acc[:nbt] += torch.where(keep, v, 0.0)
    nlive = int(hi_all[-1])
    last = torch.as_tensor(nb, device=dev) - 1
    top = block_coords_of(block[:nlive].to(torch.int64), nb) == last     # [L, d]
    octs = list(np.ndindex(*((2,) * d)))
    leaves = torch.stack([(top & torch.as_tensor(e, device=dev).bool()).any(-1)
                          for e in octs], -1)                          # [L, 2^d]
    tabs = [window_rows(e) for e in octs]
    for j, o in torch.nonzero(leaves).tolist():
        w, inwin = tabs[o]
        acc[nbt] += torch.where(inwin[:, None], tiles[j, w, :c], 0.0)
    grid_blocks.copy_(acc)
    return grid_blocks


def scatter_tiles_pull(grid_blocks, tiles, block, cum, nb, by: int):
    """The window scatter as a pull (kernel scatter_pull, csrc/
    scatter_pull.cu): the grid's momentum and mass rows grid_blocks [NB +
    1, bsd, d + 1] written row by row, bit-equal to add_rows of every slot
    into zeros; see scatter_tiles_pull_plain, which CPU tensors take.
    tiles [J, wpad, T] f32 with T a multiple of 4; block [J], cum [NB]
    int32 (build_jobs'); blocks of at most 128 nodes (by <= 8 in 3D)."""
    if grid_blocks.device.type == "cpu":
        return scatter_tiles_pull_plain(grid_blocks, tiles, block, cum, nb, by)
    from wgsparkl_tpu_torch.ops.rows import check_kernel_args

    nb = tuple(int(n) for n in nb)
    d = len(nb)
    bsd = int(np.prod(block_shape(d, by)))
    nbt = int(np.prod(nb))
    maxj, wpad, tch = tiles.shape
    if (grid_blocks.shape != (nbt + 1, bsd, d + 1) or tch % 4
            or wpad < int(np.prod(window_shape(d, by))) or bsd > 128
            or block.shape != (maxj,) or cum.shape != (nbt,)
            or grid_blocks.dtype != torch.float32 or tiles.dtype != torch.float32
            or block.dtype != torch.int32 or cum.dtype != torch.int32):
        raise ValueError("scatter_tiles_pull: f32 grid [NB + 1, bsd <= 128, d + 1], "
                         "f32 tiles [J, >= wvol, 4k], int32 block [J] and cum [NB]")
    check_kernel_args(grid_blocks, tiles, block, cum)
    _cuda.launch("scatter_pull", "scatter_pull_cuda", "ppppiiiiiiii", tiles, block,
                 cum, grid_blocks, d, nb[0], nb[1], nb[2] if d == 3 else 1, by, maxj,
                 wpad, tch)
    scatter_tiles_pull.launches += 1
    return grid_blocks


scatter_tiles_pull.launches = 0


@functools.lru_cache(maxsize=None)
def block_major_index(grid: GridConfig, device):
    """[M] int64: the block-major index (4^3 / 8^2 blocks, no ghost) of each
    row-major node: row-major arrays read block-major data through it."""
    bsh = block_shape(grid.dim, 4)
    st = storage_strides(num_blocks(grid, 4))
    cells = torch.stack(torch.meshgrid(*(torch.arange(s, device=device)
                                         for s in grid.shape), indexing="ij"), -1)
    cells = cells.reshape(-1, grid.dim)
    blk = sum((cells[:, a] // bsh[a]) * st[a] for a in range(grid.dim))
    inner = cells[:, 0] % bsh[0]
    for a in range(1, grid.dim):
        inner = inner * bsh[a] + cells[:, a] % bsh[a]
    return blk * int(np.prod(bsh)) + inner


def to_blocks(flat, grid: GridConfig, ghost_value=0):
    """Row-major node values [M, ...] -> block-major [NB + 1, BS.., ...]
    (4^3 / 8^2 blocks; the ghost block NB holds ghost_value)."""
    bs = block_size(grid.dim)
    nb_total = int(np.prod(num_blocks(grid)))
    tail = tuple(flat.shape[1:])
    out = torch.full((nb_total * bs ** grid.dim + bs ** grid.dim, *tail), ghost_value,
                     dtype=flat.dtype, device=flat.device)
    out[block_major_index(grid, flat.device)] = flat
    return out.reshape(nb_total + 1, *((bs,) * grid.dim), *tail)


def from_blocks(blocked, grid: GridConfig):
    """Block-major [NB + 1, BS.., ...] -> row-major [M, ...] (the ghost block
    dropped)."""
    tail = tuple(blocked.shape[1 + grid.dim:])
    flat = blocked.reshape(-1, *tail)
    return flat[block_major_index(grid, blocked.device)]


def block_major_node_positions_ch(cfg: GridConfig, by: int, device):
    """Node world-position channels in block-major storage order."""
    bsh = block_shape(cfg.dim, by)
    nb = num_blocks(cfg, by)
    bsd = int(np.prod(bsh))
    i = torch.arange(int(np.prod(nb)) * bsd, dtype=torch.int32, device=device)
    inner = i % bsd
    b = i // bsd
    st = storage_strides(nb)
    out = []
    for a in range(cfg.dim):
        inner_stride = int(np.prod(bsh[a + 1:]))
        cell = ((b // st[a]) % nb[a] * bsh[a] + (inner // inner_stride) % bsh[a]
                + int(cfg.origin_cell[a]))
        out.append(cell.to(torch.float32) * cfg.cell_width)
    return out


# ------------------------------------------------------------ sparse domain
#
# The unbounded 3D domain (port of the JAX package's sparse functions):
# blocks are 4^3 nodes anywhere within +-511 block coordinates of the grid
# origin.  A block's packed key holds its (x, z, y) digits of SPARSE_DIM
# (gravity fastest, as the bounded flat ids); the top digit is reserved so
# that a +1 neighbour never carries into the next digit.  Each substep the
# occupied blocks come from the sorted particle keys, their {0,1}^3
# neighbourhood forms the sorted active table, and grid storage is
# [amax + 1, 64, C] slots into that table (slot amax: the ghost).

SPARSE_HALF = 512
SPARSE_DIM = 2 * SPARSE_HALF
SPARSE_SENTINEL = 1 << 30     # out-of-range block, dead job, table padding


def sparse_octant_deltas() -> Tuple[int, ...]:
    """Packed-key delta of each {0,1}^3 neighbour, octants in np.ndindex
    order (window_map's)."""
    stride = (SPARSE_DIM * SPARSE_DIM, 1, SPARSE_DIM)
    return tuple(int(sum(e[a] * stride[a] for a in range(3)))
                 for e in np.ndindex(2, 2, 2))


def particle_sparse_keys_ch(pch, cfg: GridConfig):
    """Packed block key per lane of the 3 position channels pch (block of
    the stencil base cell round(p / h) - 1); blocks past +-(SPARSE_HALF - 1)
    of the origin get SPARSE_SENTINEL."""
    digs, ok = [], None
    for a in range(3):
        base = torch.round(div(pch[a], cfg.cell_width)).to(torch.int32) - 1
        dig = torch.div(base - int(cfg.origin_cell[a]), 4,
                        rounding_mode="floor") + SPARSE_HALF
        oka = (dig >= 0) & (dig < SPARSE_DIM - 1)
        ok = oka if ok is None else ok & oka
        digs.append(dig)
    key = (digs[0] * SPARSE_DIM + digs[2]) * SPARSE_DIM + digs[1]
    return torch.where(ok, key, SPARSE_SENTINEL).to(torch.int32)


def sparse_key_coords(key):
    """Packed key -> [..., 3] int32 block coords relative to the origin
    (garbage for sentinel keys)."""
    y = torch.remainder(key, SPARSE_DIM)
    rest = torch.div(key, SPARSE_DIM, rounding_mode="floor")
    z = torch.remainder(rest, SPARSE_DIM)
    x = torch.div(rest, SPARSE_DIM, rounding_mode="floor")
    return (torch.stack([x, y, z], dim=-1) - SPARSE_HALF).to(torch.int32)


def _first_of_run(x):
    first = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    first[1:] = x[1:] != x[:-1]
    return first


def build_jobs_sparse(sorted_keys, group: int, max_jobs: int, kmax: int):
    """Job table and occupied-block table from sorted packed keys: (jobs
    {key (SPARSE_SENTINEL for dead jobs), start, len, needed}, okeys
    [min(kmax, N)] sorted occupied keys padded with the sentinel, n_occ
    (distinct occupied blocks before truncation)), bit-equal to the JAX
    package's: the blocks past kmax get no job of their own, but the last
    kept block's count runs over their lanes (freeze_truncated_blocks cuts
    it back).

    The first rank of each occupied block is the index row of kernel E,
    which packs the indices of the flagged lanes (block boundaries) in lane
    order, with no value row: keys reach 2^30, past E's exact f32 range, so
    the keys are read back from sorted_keys at those ranks.  That is what
    the JAX package's sort of (key, rank) pairs gives, since sorted keys
    already come in rank order."""
    from wgsparkl_tpu_torch.ops.compact import compact_flagged

    dev = sorted_keys.device
    n = sorted_keys.shape[0]
    if n >= 2 ** 24:
        raise ValueError("build_jobs_sparse: ranks must stay below 2^24")
    cap = min(kmax, n)
    occ = _first_of_run(sorted_keys) & (sorted_keys < SPARSE_SENTINEL)
    cidx, _ = compact_flagged(torch.empty((0, n), dtype=torch.float32, device=dev),
                              occ, cap)
    brank = torch.clamp(cidx[0], max=float(n)).to(torch.int32)
    valid = brank < n
    bkey = torch.where(valid, sorted_keys[torch.clamp(brank, max=n - 1).long()],
                       SPARSE_SENTINEL).to(torch.int32)
    n_occ = occ.sum(dtype=torch.int32)
    first_over = torch.searchsorted(
        sorted_keys, torch.full((1,), SPARSE_SENTINEL, dtype=sorted_keys.dtype,
                                device=dev)).to(torch.int32)
    nxt = torch.cat([brank[1:], torch.full((1,), n, dtype=torch.int32, device=dev)])
    nxt = torch.where(nxt < n, nxt, first_over)
    counts = torch.where(valid, nxt - brank, 0)
    cum = torch.cumsum((counts + (group - 1)) // group, 0, dtype=torch.int32)
    total = cum[-1]
    job_idx = torch.arange(max_jobs, dtype=torch.int32, device=dev)
    jb = torch.searchsorted(cum, job_idx, right=True).to(torch.int32)
    live = job_idx < total
    jb_safe = torch.where(live, torch.clamp(jb, max=cap - 1), 0).long()
    prev = torch.where(jb_safe > 0, cum[torch.clamp(jb_safe - 1, min=0)], 0)
    rank = job_idx - prev
    start = brank[jb_safe] + rank * group
    length = torch.where(live, torch.clamp(counts[jb_safe] - rank * group, 0, group), 0)
    return ({"key": torch.where(live, bkey[jb_safe], SPARSE_SENTINEL).to(torch.int32),
             "start": start.to(torch.int32), "len": length.to(torch.int32),
             "needed": total}, bkey, n_occ)


def freeze_truncated_blocks(jobs, okeys, sorted_keys):
    """The job table of build_jobs_sparse cut back to the kept blocks'
    lanes.  Under occupied-block overflow that table lets the last kept
    block's count run to the first out-of-range lane, so its jobs would
    carry the truncated blocks' particles through a window that does not
    hold them; cut at the end of the last kept block's own run, the
    truncated blocks' particles get no job and freeze."""
    last = torch.max(torch.where(okeys < SPARSE_SENTINEL, okeys, -1))
    end = torch.searchsorted(sorted_keys, last.reshape(1).to(sorted_keys.dtype),
                             right=True).to(torch.int32)
    length = torch.clamp(torch.minimum(jobs["len"], end - jobs["start"]), min=0)
    return dict(jobs, len=length.to(torch.int32))


def sparse_active_table(okeys, amax: int):
    """The sorted active table, occupied blocks and their {0,1}^3
    neighbours: (act [amax] padded with the sentinel, n_active before
    truncation)."""
    cand = torch.cat([okeys + dl for dl in sparse_octant_deltas()])
    cand = torch.sort(torch.clamp(cand, max=SPARSE_SENTINEL)).values
    isf = _first_of_run(cand) & (cand < SPARSE_SENTINEL)
    act = torch.sort(torch.where(isf, cand, SPARSE_SENTINEL)).values[:amax]
    return act.to(torch.int32), isf.sum(dtype=torch.int32)


def sparse_slots(act, queries, ghost_slot: int):
    """Slot of each query key in the sorted active table; ghost_slot when
    it is absent or the sentinel."""
    s = torch.clamp(torch.searchsorted(act, queries.to(act.dtype).contiguous()),
                    max=act.shape[0] - 1)
    found = (act[s] == queries) & (queries < SPARSE_SENTINEL)
    return torch.where(found, s, ghost_slot).to(torch.int32)


def window_sources_slots(tgts):
    """[J, 216] slot-addressed grid row (slot * 64 + cell) of every window
    node of a 4^3 block: tgts [8, J] holds the slot of each job's octant
    neighbour, octants in sparse_octant_deltas order."""
    octs, cells = _window_tables((1, 1, 1), 4, tgts.device)[1:]
    return tgts.long()[octs].T * 64 + cells[None, :]
