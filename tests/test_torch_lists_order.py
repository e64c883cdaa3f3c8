"""The orders of sums and the stencil addressing of kernels A and F (the
lists order), H (2D P2G) and B (3D G2P), on the CPU with inputs made with
numpy from a seed.

- rows.lists_order, the lists core's order of each window node's pairs in
  kernels A and F, against a brute-force order, in one chunk and several.
- Kernel H's walk (csrc/p2g2d.cu): each particle in the bucket of its
  stencil base cell + 1, each window node taking the particles of the 9
  buckets its offsets reach, in particle order, at offset node + 1 -
  bucket: exactly R.stencil's pairs, in the order the plain version sums
  them, edge nodes dropped.
- Kernels B's and I's per-axis stencil (_axis_nodes, the rule of
  csrc/transfer.cuh stencil_axis_nodes and csrc/transfer2d.cuh
  stencil_axis_nodes2): validity, node index and node coordinate equal to
  R.stencil's and R.window_positions' bit for bit, edge nodes dropped.
Both walks are checked on particles at exact half-cell ties and where
p * (1/h) rounds below the p / h of the block sort key."""

import itertools

import numpy as np
import pytest
import torch

from wgsparkl_tpu_torch.ops import rows as R
from wgsparkl_tpu_torch.ops import rows2d as R2

torch.set_num_threads(2)


def _brute_force_order(lens, chunk, noff):
    """(particle, offset) pairs, row-major indices, in the lists order:
    job by job, chunk by chunk, offsets in order, particles in order."""
    out, first = [], 0
    for n in lens:
        for c0 in range(0, n, chunk):
            members = range(first + c0, first + min(n, c0 + chunk))
            out += [p * noff + o for o in range(noff) for p in members]
        first += n
    return out


@pytest.mark.parametrize("chunking", ["one_chunk", "several_chunks"])
def test_lists_order_matches_brute_force(chunking):
    rng = np.random.default_rng(len(chunking))
    lens = rng.integers(0, 20, 12)
    lens[3] = 0                                     # a dead job among them
    chunk = 7 if chunking == "several_chunks" else int(lens.max())
    assert (lens > chunk).any() == (chunking == "several_chunks")
    jobs = {"start": torch.zeros(len(lens), dtype=torch.int32),
            "len": torch.as_tensor(lens, dtype=torch.int32)}
    jid, _ = R.job_lanes(jobs)
    order = R.lists_order(jid, jobs["len"], chunk)
    total = int(lens.sum()) * 27
    assert torch.equal(torch.sort(order).values, torch.arange(total))
    assert order.tolist() == _brute_force_order(lens.tolist(), chunk, 27)
    # Chunks of one particle: particle order.
    assert torch.equal(R.lists_order(jid, jobs["len"], 1), torch.arange(total))


def _edge_particles(h, bsh, rng):
    """Positions [d, P] near half cells on every axis and their job cells
    [P, d] for blocks of bsh cells: each a block origin the sort key allows
    (its base round(p / h) - 1 in the block), at the block's low edge where
    the stencil base lies below the key's and at its high edge where it
    lies above, so that both edge cases drop a node.  Returns (pos, bcell,
    low, high), low / high: a node below / past the window on some axis."""
    inv_h = np.float32(1.0) / np.float32(h)
    pos, bcell, lows, highs = [], [], [], []
    for a in range(len(bsh)):
        k = rng.integers(-300, 300, 60_000)
        q = ((k + 0.5) * h).astype(np.float32)
        q = np.concatenate([q, np.nextafter(q, np.float32(1e9)),
                            np.nextafter(q, np.float32(-1e9))])
        rng.shuffle(q)
        key_base = (torch.round(torch.as_tensor(q) / float(np.float32(h))).numpy()
                    .astype(np.int64) - 1)
        base = np.floor(q * inv_h + np.float32(0.5)).astype(np.int64) - 1
        r = rng.integers(0, bsh[a], len(q))               # key base - block origin
        r = np.where(base < key_base, 0, np.where(base > key_base, bsh[a] - 1, r))
        pos.append(q)
        bcell.append(key_base - r)
        lows.append(base < key_base)
        highs.append(base > key_base)
    low, high = np.any(lows, 0), np.any(highs, 0)
    ordinary = rng.permutation(np.flatnonzero(~low & ~high))[:2000]
    pick = np.concatenate([np.flatnonzero(low)[:500], np.flatnonzero(high)[:500],
                           ordinary])
    return np.stack(pos)[:, pick], np.stack(bcell, axis=1)[pick], low[pick], high[pick]


def _bucket_walk(bl, wsh):
    """Kernel H's walk in numpy: {window node: [(particle, ox, oy), ...]}
    for stencil base cells bl [P, 2] relative to the block (wsh nodes an
    axis): particle q in bucket bl + 1 when inside the window; node n
    takes the particles of buckets n + 1 - o in particle order, at offset
    o = n + 1 - bucket."""
    b = bl + 1
    inside = ((b >= 0) & (b < wsh)).all(1)
    walk = {}
    for n in range(wsh * wsh):
        off = np.array(divmod(n, wsh)) + 1 - b
        take = inside & ((off >= 0) & (off <= 2)).all(1)
        walk[n] = [(int(q), int(off[q, 0]), int(off[q, 1]))
                   for q in np.flatnonzero(take)]
    return walk


@pytest.mark.parametrize("h", [0.2, 0.5, 0.3])
def test_p2g2d_bucket_walk_matches_stencil(h):
    rng = np.random.default_rng(int(h * 10))
    pos, bcell, low, high = _edge_particles(h, (8, 8), rng)
    assert high.sum() > 50 and (low.sum() > 50 if h != 0.5 else not low.any())
    inv_h = float(np.float32(1.0) / np.float32(h))
    pt = [torch.as_tensor(pos[a]) for a in range(2)]
    bc = torch.as_tensor(bcell)
    _, nidx, valid = R.stencil(pt, bc, inv_h, R2.WSH)
    bl = torch.stack([torch.floor(pt[a] * inv_h + 0.5).to(torch.int64) - 1 - bc[:, a]
                      for a in range(2)], 1).numpy()
    # The block sort keeps every base cell + 1 inside the window.
    assert ((bl >= -1) & (bl <= 8)).all()
    want = {n: [] for n in range(R2.WVOL)}
    for q in range(len(bcell)):
        for o in range(9):
            if valid[q, o]:
                want[int(nidx[q, o])].append((q, o // 3, o % 3))
    assert _bucket_walk(bl, R2.WSH[0]) == want
    assert not bool(valid[torch.as_tensor(low | high)].all())


def _axis_nodes(pos, bcell, inv_h, cell_width, wsh):
    """Kernel B's stencil per axis (csrc/transfer.cuh stencil_axis_nodes)
    in PyTorch: for each axis a, the stencil base cell bl[a] [P] relative
    to the block origin bcell [P, d] (R.stencil's), whether offset o lies
    in the window (0 <= bl[a] + o < wsh[a]), and its node coordinate
    ((bl[a] + o) + bcell[a]) * h in f32.  Node (o_0, .., o_{d-1}) lies in
    the window when each of its offsets does; its index is the row-major
    ((bl[0] + o_0) * wsh[1] + bl[1] + o_1) * wsh[2] + .. .  Returns (bl, ok
    [d][3], xa [d][3])."""
    bl, ok, xa = [], [], []
    for a in range(len(pos)):
        b = torch.floor(pos[a] * inv_h + 0.5).to(torch.int64) - 1 - bcell[:, a]
        bl.append(b)
        ok.append([(b + o >= 0) & (b + o < wsh[a]) for o in range(3)])
        bf = bcell[:, a].to(torch.float32)
        xa.append([((b + o).to(torch.float32) + bf) * cell_width for o in range(3)])
    return bl, ok, xa


def _check_axis_nodes(h, bsh, wsh, rng):
    """The per-axis stencil of kernels B and I against R.stencil and
    R.window_positions on particles at the window's edges, bit for bit."""
    pos, bcell, low, high = _edge_particles(h, bsh, rng)
    # Ties round up past the window at every cell width; p * (1/h) rounds
    # below p / h only where 1/h is inexact.
    assert high.sum() > 50 and (low.sum() > 50 if h != 0.5 else not low.any())
    d = len(bsh)
    hf = float(np.float32(h))
    inv_h = float(np.float32(1.0) / np.float32(h))
    pt = [torch.as_tensor(pos[a]) for a in range(d)]
    bc = torch.as_tensor(bcell)
    _, nidx, valid = R.stencil(pt, bc, inv_h, wsh)
    xw = R.window_positions(bc, hf, wsh)                     # [P, wvol, d]
    bl, ok, xa = _axis_nodes(pt, bc, inv_h, hf, wsh)
    dropped = 0
    for o, offs in enumerate(itertools.product(range(3), repeat=d)):
        ok_n, idx = ok[0][offs[0]], bl[0] + offs[0]
        for a in range(1, d):
            ok_n = ok_n & ok[a][offs[a]]
            idx = idx * wsh[a] + bl[a] + offs[a]
        assert torch.equal(ok_n, valid[:, o])
        dropped += int((~ok_n).sum())
        assert torch.equal(idx[ok_n], nidx[ok_n, o])
        at = xw[torch.arange(len(idx)), nidx[:, o]]          # [P, d]
        for a, off in enumerate(offs):
            assert torch.equal(xa[a][off][ok_n], at[ok_n, a])
    assert dropped > 0 and bool(valid[~torch.as_tensor(low | high)].all())


@pytest.mark.parametrize("h,by", [(0.2, 8), (0.5, 8), (0.3, 4)])
def test_g2p_axis_nodes_match_stencil(h, by):
    _check_axis_nodes(h, (4, by, 4), (6, by + 2, 6),
                      np.random.default_rng(int(h * 10) + by))


@pytest.mark.parametrize("h", [0.2, 0.5, 0.3])
def test_g2p2d_axis_nodes_match_stencil(h):
    """Kernel I's walk (csrc/transfer2d.cuh stencil_axis_nodes2): the 3 x 3
    stencil per axis in the 10 x 10 window, node index (bl[0] + ox) * 10 +
    bl[1] + oy."""
    _check_axis_nodes(h, (8, 8), R2.WSH, np.random.default_rng(int(h * 10) + 100))
