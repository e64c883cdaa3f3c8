"""Kernels D (lane permutation) and E (flagged-lane compaction) and the job
table of the PyTorch port against the JAX package (Pallas in interpret
mode on the CPU), on seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgsparkl_tpu.ops import blocked as jbk
from wgsparkl_tpu.ops.compact import compact_flagged as j_compact
from wgsparkl_tpu.ops.permute import permute_lanes as j_permute
from wgsparkl_tpu_torch.ops import blocked as bk
from wgsparkl_tpu_torch.ops.compact import compact_flagged, compact_plain
from wgsparkl_tpu_torch.ops.permute import permute_lanes

torch.set_num_threads(2)


def _perm(rng, npad, kind):
    if kind == "random":
        return rng.permutation(npad).astype(np.int32)
    # A re-sort: mostly local shifts plus a few far movers.
    keys = np.arange(npad) + rng.integers(-40, 40, npad)
    far = rng.choice(npad, npad // 50, replace=False)
    keys[far] = rng.integers(0, npad, len(far))
    return np.argsort(keys, kind="stable").astype(np.int32)


@pytest.mark.parametrize("kind", ["resort", "random"])
def test_permute_lanes_matches_jax(kind):
    rng = np.random.default_rng(5)
    npad = 4096
    rows = rng.standard_normal((48, npad)).astype(np.float32)
    rows[16] = rng.integers(0, 2 ** 16, npad)     # affinity halves: integers
    perm = _perm(rng, npad, kind)
    ref = np.asarray(j_permute(jnp.asarray(rows), jnp.asarray(perm)))
    out = permute_lanes(torch.as_tensor(rows), torch.as_tensor(perm))
    np.testing.assert_array_equal(out.numpy(), ref)


def _compact_contract(vals, flag, cap):
    """compact_flagged's contract in numpy: (out [R + 1, cap], ok)."""
    idx = np.flatnonzero(flag)
    k = min(len(idx), cap)
    out = np.full((vals.shape[0] + 1, cap), 2.0 ** 24, np.float32)
    out[:-1, :k] = vals[:, idx[:k]]
    out[-1, :k] = idx[:k]
    return out, len(idx) <= cap


# (density, N, cap, R): N a multiple of 1024 and not, below one
# 16384-lane tile of the CUDA kernel, no flag, every flag, more flags than
# cap (tiles in numbers: test_compact_single_pass_matches_plain).
COMPACT_CASES = [
    pytest.param(0.01, 8192, 300, 2, id="0.01"),
    pytest.param(0.05, 8192, 300, 2, id="0.05"),
    pytest.param(0.0, 8192, 300, 2, id="none_flagged"),
    pytest.param(1e-3, 10_000, 300, 1, id="sparse_ragged"),
    pytest.param(0.05, 700, 300, 2, id="below_one_tile"),
    pytest.param(1.0, 3000, 4000, 2, id="all_flagged"),
    pytest.param(0.05, 8192, 100, 1, id="over_cap"),
    pytest.param(1.0, 5000, 1000, 1, id="all_flagged_over_cap"),
]


@pytest.mark.parametrize("density,n,cap,r", COMPACT_CASES)
def test_compact_flagged_matches_jax(density, n, cap, r):
    rng = np.random.default_rng(6)
    vals = rng.integers(0, 2 ** 24, (r, n)).astype(np.float32)
    flag = rng.random(n) < density
    want, want_ok = _compact_contract(vals, flag, cap)
    out, ok_t = compact_flagged(torch.as_tensor(vals), torch.as_tensor(flag), cap)
    np.testing.assert_array_equal(out.numpy(), want)
    assert bool(ok_t) == want_ok == (flag.sum() <= cap)
    ref, ok = j_compact(jnp.asarray(vals), jnp.asarray(flag), cap)
    # The JAX package's chunks hold at most 128 flagged lanes of 2048; past
    # that its result is invalid and it says so (ok False, the caller sorts).
    chunk = min(2048, n)
    counts = np.add.reduceat(flag, np.arange(0, n, chunk))
    if counts.max() <= 128:
        assert bool(ok) == want_ok
        np.testing.assert_array_equal(np.asarray(ref), want)
    else:
        assert not bool(ok)


FILL = 32      # columns a fill block writes (csrc/compact.cu FILL, scaled down)


def _single_pass(vals, flag, cap, tile, window, rng):
    """Kernel E's one-pass decomposition (csrc/compact.cu) in numpy, its
    blocks interleaved at random: blocks start in ticket order (a started
    block never waits on one that has not started) and then advance in any
    order.  A tile ranks its flags in threads of 16 lanes, publishes its
    aggregate (or, tile 0, its inclusive prefix), looks back over windows
    of `window` status words up to the nearest inclusive prefix, waiting
    while a word it reads is not ready, publishes its inclusive prefix and
    writes each flagged lane at its rank below cap; the last tile writes
    ok.  Fill blocks wait for the last tile's prefix and write 2^24 on
    their columns past the total.  Returns (out, ok, look-back rounds)."""
    r, n = vals.shape
    ntiles, nfill = -(-n // tile), -(-cap // FILL)
    status = [None] * ntiles                 # None, ("A", agg) or ("P", prefix)
    out = np.full((r + 1, cap), np.nan, np.float32)
    res = {"ok": None, "rounds": 0}      # rounds: the most a tile took

    def tile_block(t):
        f = flag[t * tile:(t + 1) * tile]
        counts = [int(f[i:i + 16].sum()) for i in range(0, len(f), 16)]
        thread_excl = np.cumsum([0] + counts[:-1])
        agg = sum(counts)
        status[t] = ("P" if t == 0 else "A", agg)
        yield
        excl, idx, rounds = 0, t - 1, 0
        while idx >= 0:
            rounds += 1
            res["rounds"] = max(res["rounds"], rounds)
            words = [status[idx - k] if idx - k >= 0 else ("P", 0)
                     for k in range(window)]
            while any(w is None for w in words):
                yield
                words = [status[idx - k] if idx - k >= 0 else ("P", 0)
                         for k in range(window)]
            stop = next((k for k, w in enumerate(words) if w[0] == "P"), None)
            excl += sum(w[1] for w in words[:window if stop is None else stop + 1])
            if stop is not None:
                break
            idx -= window
        if t > 0:
            status[t] = ("P", excl + agg)
            yield
        for i, first in enumerate(range(t * tile, min(n, (t + 1) * tile), 16)):
            rank = excl + int(thread_excl[i])
            for lane in range(first, min(n, first + 16)):
                if flag[lane]:
                    if rank < cap:
                        out[:r, rank] = vals[:, lane]
                        out[r, rank] = lane
                    rank += 1
        if t == ntiles - 1:
            res["ok"] = excl + agg <= cap

    def fill_block(f):
        while ntiles and (status[-1] is None or status[-1][0] != "P"):
            yield
        total = status[-1][1] if ntiles else 0
        out[:, max(f * FILL, total):min((f + 1) * FILL, cap)] = 2.0 ** 24
        if not ntiles and f == 0:
            res["ok"] = True

    pending = [tile_block(t) for t in range(ntiles)] + [fill_block(f) for f in range(nfill)]
    running = []
    while pending or running:
        if pending and (not running or rng.random() < 0.3):
            running.append(pending.pop(0))
        else:
            b = running[rng.integers(len(running))]
            try:
                next(b)
            except StopIteration:
                running.remove(b)
    return out, res["ok"], res["rounds"]


@pytest.mark.parametrize("seed", range(6))
def test_compact_single_pass_matches_plain(seed):
    """The decomposition in random block orders equals compact_plain bit for
    bit: N a multiple of the tile or not, below one tile, no flag, every
    flag, more flags than cap, R = 1 and 2, several look-back rounds."""
    rng = np.random.default_rng(seed)
    tile, window = 64, 4
    rounds = 0
    for n, density, cap, r in ((2000, 0.05, 150, 1), (1024, 0.3, 400, 2),
                               (50, 0.5, 40, 2), (700, 0.0, 33, 1),
                               (640, 1.0, 700, 2), (640, 1.0, 500, 1)):
        vals = rng.integers(0, 2 ** 24, (r, n)).astype(np.float32)
        flag = rng.random(n) < density
        out, ok, k = _single_pass(vals, flag, cap, tile, window, rng)
        rounds = max(rounds, k)
        want, want_ok = compact_plain(torch.as_tensor(vals), torch.as_tensor(flag), cap)
        np.testing.assert_array_equal(out, want.numpy())
        assert ok == bool(want_ok)
    assert rounds > 1


def test_build_jobs_matches_jax():
    rng = np.random.default_rng(7)
    nb_total, n, group, max_jobs = 300, 6144, 64, 256
    keys = rng.integers(0, nb_total, n - 500)
    keys = np.concatenate([keys, np.full(300, nb_total), np.full(200, nb_total + 1)])
    sids = np.sort(keys).astype(np.int32)
    ref = jbk.build_jobs(jnp.asarray(sids), nb_total, group, max_jobs)
    out = bk.build_jobs(torch.as_tensor(sids), nb_total, group, max_jobs)
    for k in ("block", "start", "len", "needed"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    assert int(out["needed"]) > 0
