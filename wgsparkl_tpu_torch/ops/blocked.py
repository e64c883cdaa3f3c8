"""Block-grid addressing, sort keys, job tables and window tile moves
(port of the bounded-grid and sparse-domain subset of
wgsparkl_tpu/ops/blocked.py; the sparse domain's keys and tables at the
end).

Blocks are 4 x by x 4 nodes in 3D, 8 x 8 in 2D; flat block ids enumerate
blocks gravity (y) fastest ((x, z, y) order in 3D, (x, y) in 2D, x
slowest in both) and double as the particle sort keys.  Grid storage is
[NB + 1, bsd, C] (bsd nodes per block): slot NB is the ghost block that dead
jobs and out-of-range window neighbours read and write.  The TPU's one-hot
matmul tile moves (banded slabs, two-level dispatch, Dekker selection
splits) become a plain indexed gather and an ordered row add (add_rows) here.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from wgsparkl_tpu_torch.grid import GridConfig
from wgsparkl_tpu_torch.math import div


BLOCK2D = 8   # nodes per axis of a 2D block


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


def particle_sort_keys_ch(pch, cfg: GridConfig, by: int = 4):
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


def particle_block_ids(pos, cfg: GridConfig):
    """Flat home-block id [N] of particles at pos [N, d] (the blocked
    transfer's 4^3 / 8^2 blocks): the block of the stencil base cell
    round(p / h) - 1; particles off the grid get NB (the overflow bucket,
    sorted last).  The sort itself (JAX's sort_by_block) is
    pipeline.sort_by_block, on the row matrix."""
    return particle_sort_keys_ch([pos[:, a] for a in range(pos.shape[1])], cfg)


def key_to_block(key, nb, dim: int):
    """Sort key -> storage block id: the identity (storage is y-fastest)."""
    return key


def build_jobs(sorted_ids, nb_total: int, group: int, max_jobs: int):
    """Job table from sorted block ids: dict of [max_jobs] int32 tensors
    block (flat id; NB for dead jobs), start (first sorted rank), len
    (<= group; 0 for dead jobs), plus needed (0-d: jobs the substep asked
    for; > max_jobs means the tail was dropped)."""
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
