"""The multi-device step's exchange units against the JAX package's, bit for
bit, at 2 and 4 ranks.

The port's ranks run through wgsparkl_tpu_torch/parallel/launch.py on gloo
(spawned CPU processes, `launch.unit_job`); the JAX functions run inside
`jax.shard_map` over the first 2 or 4 virtual CPU devices of
tests/conftest.py.  The inputs are made from a numpy seed.  Migration and
the halo moves are data movement and each halo add has two operands, so
every output is compared bit for bit (as uint32):

  * `_migrate_x`: the migrated and re-sorted rows, their keys and
    migration_dropped, with movers within and beyond the capacity;
  * `_halo_exchange_x`: a 3D and a 2D block grid;
  * `_halo_exchange_sparse`: slot grids whose boundary planes hold keys the
    neighbour has and keys it lacks (those route to the ghost slot with a
    zero payload, and the ghost stays zero), within and beyond halo_cap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from wgsparkl_tpu import pipeline as jp
from wgsparkl_tpu_torch.ops import blocked as bk
from wgsparkl_tpu_torch.parallel import launch

WORLDS = (2, 4)
# Migration: C rows of NPAD lanes, N_LIVE live; keys in slabs of W.
C, NPAD, N_LIVE, W, KEY_ROW, PM = 8, 256, 160, 16, 0, 1
MIGRATE_CAPS = (8, 48)
# Halo planes: wx x-blocks a slab; 3D planes of 2 x 3 blocks, 2D of 3.
WX = 2
HALO_X = {"3d": (6, (4, 4, 4, 4), (64, 4)), "2d": (3, (8, 8, 3), (64, 3))}
# Sparse: slabs of 2 nominal x blocks; (y, z) digits in 0..2.
AMAX, SPARSE_CAPS = 48, (64, 3)


def _key(x, y, z):
    h, dim = bk.SPARSE_HALF, bk.SPARSE_DIM
    return ((x + h) * dim + (z + h)) * dim + (y + h)


def _slab(r, world):
    """(lo, hi) of rank r: bounded keys in slabs of W; sparse keys in
    slabs of WX nominal x blocks, the edges owning everything beyond."""
    dd2 = bk.SPARSE_DIM * bk.SPARSE_DIM
    lo = (bk.SPARSE_HALF + r * WX) * dd2 if r > 0 else 0
    hi = (bk.SPARSE_HALF + (r + 1) * WX) * dd2 if r < world - 1 else bk.SPARSE_SENTINEL
    return (r * W, (r + 1) * W), (lo, hi)


def _inputs(world):
    """Per rank, the list of (unit, kw) and the case names, in order."""
    rng = np.random.default_rng(100 + world)
    live = world * W
    ranks = [[] for _ in range(world)]
    names = []
    for capx in MIGRATE_CAPS:
        names.append(f"migrate-cap{capx}")
        for r in range(world):
            rows = rng.standard_normal((C, NPAD)).astype(np.float32)
            u = rng.random(N_LIVE)
            own = rng.integers(r * W, (r + 1) * W, N_LIVE)
            left = rng.integers(max(r - 1, 0) * W, max(r, 1) * W, N_LIVE)
            right = rng.integers(min(r + 1, world - 1) * W, min(r + 2, world) * W,
                                 N_LIVE)
            keys = np.where(u < 0.14, left, np.where(u < 0.28, right, own))
            keys = np.where(u > 0.95, live, keys)
            rows[KEY_ROW] = 0.0
            rows[KEY_ROW, :N_LIVE] = keys
            rows[PM] = 0.0
            rows[PM, :N_LIVE] = rng.uniform(0.5, 1.5, N_LIVE)
            (lo, hi), _ = _slab(r, world)
            ranks[r].append(("migrate", dict(rows=rows, key_row=KEY_ROW, pm=PM,
                                              live_key=live, lo_key=lo, hi_key=hi,
                                              capx=capx)))
    for tag, (p2, jshape, tshape) in HALO_X.items():
        names.append(f"halo_x-{tag}")
        nb_total = world * WX * p2
        for r in range(world):
            g = rng.standard_normal((nb_total + 1,) + tshape).astype(np.float32)
            g[nb_total] = 0.0
            ranks[r].append(("halo_x", dict(grid=g, p2=p2, wx=WX)))
    for cap in SPARSE_CAPS:
        names.append(f"halo_sparse-cap{cap}")
        for r in range(world):
            xs = range(r * WX - (r == 0), (r + 1) * WX + 1 + (r == world - 1))
            keys = sorted(_key(x, y, z) for x in xs for y in range(3) for z in range(3)
                          if rng.random() < 0.7)
            act = np.full(AMAX, bk.SPARSE_SENTINEL, np.int32)
            act[:len(keys)] = keys
            g = rng.standard_normal((AMAX + 1, 64, 4)).astype(np.float32)
            g[AMAX] = 0.0
            _, (lo, hi) = _slab(r, world)
            ranks[r].append(("halo_sparse", dict(grid=g, act=act, amax=AMAX, lo_key=lo,
                                                  hi_key=hi, halo_cap=cap)))
    return ranks, names


def _shard_map(fn, world, *stacked):
    """fn on each of `world` virtual devices, on its slice of the stacked
    [world, ...] inputs; outputs stacked the same way."""
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("dp",))

    def local(*xs):
        return jax.tree.map(lambda o: o[None], fn(*(x[0] for x in xs)))

    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=P("dp"), out_specs=P("dp"),
                                 check_vma=False))(*stacked)


def _jax_unit(unit, kws, world):
    """The JAX package's unit on the ranks' inputs kws, outputs per rank."""
    st = lambda k: np.stack([kw[k] for kw in kws])  # noqa: E731
    kw0 = kws[0]
    if unit == "migrate":
        live, capx = kw0["live_key"], kw0["capx"]
        lo, hi = st("lo_key"), st("hi_key")

        def fn(rows, lo, hi):
            lane = jnp.arange(rows.shape[1], dtype=jnp.int32)

            def sort_rows(r):
                kk = jnp.where(r[PM] > 0.0, r[KEY_ROW].astype(jnp.int32), live + 1)
                sids, perm = jax.lax.sort((kk, lane), num_keys=1)
                return r[:, perm], sids

            rows, sids = sort_rows(rows)
            rows, sids, diag = jp._migrate_x(
                rows, sids, lo, hi, live, rows.shape[1], capx, "dp", world,
                jp.StepDiag.zeros(), sort_rows, C, PM)
            return rows, sids, diag.migration_dropped

        out = _shard_map(fn, world, st("rows"), lo, hi)
        return [tuple(np.asarray(o[r]) for o in out) for r in range(world)]
    if unit == "halo_x":
        p2 = kw0["p2"]
        jshape = next(j for q, j, _ in HALO_X.values() if q == p2)
        g = st("grid")
        g = g.reshape(g.shape[:2] + jshape)

        def fn(grid):
            kdev = jax.lax.axis_index("dp")
            return jp._halo_exchange_x(grid, grid.shape[0] - 1, p2, kdev, WX, world, "dp")

        out = np.asarray(_shard_map(fn, world, g))
        return [out[r].reshape(kws[r]["grid"].shape) for r in range(world)]

    def fn(grid, act, lo, hi):
        kdev = jax.lax.axis_index("dp")
        out, diag = jp._halo_exchange_sparse(grid, act, AMAX, lo, hi, kw0["halo_cap"],
                                             kdev, world, "dp", jp.StepDiag.zeros())
        return out, diag.halo_dropped

    g = st("grid")
    out = _shard_map(fn, world, g.reshape(g.shape[:2] + (4, 4, 4, 4)), st("act"),
                     st("lo_key"), st("hi_key"))
    return [(np.asarray(out[0][r]).reshape(kws[r]["grid"].shape), int(out[1][r]))
            for r in range(world)]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def both(request):
    """(names, the port's outputs, JAX's outputs) of every unit at a world
    size: the port's from one launch of its ranks."""
    world = request.param
    ranks, names = _inputs(world)
    port = launch.run(launch.unit_job, world, rank_args=[(u,) for u in ranks])
    ref = []
    for i, _ in enumerate(names):
        unit = ranks[0][i][0]
        ref.append(_jax_unit(unit, [ranks[r][i][1] for r in range(world)], world))
    return world, names, ranks, port, ref


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _case(both, name):
    world, names, ranks, port, ref = both
    i = names.index(name)
    return world, [ranks[r][i][1] for r in range(world)], [port[r][i] for r in range(world)], \
        ref[i]


@pytest.mark.parametrize("capx", MIGRATE_CAPS)
def test_migrate_x_matches_jax_bit_for_bit(both, capx):
    """Rows, keys and the dropped count of every rank equal JAX's; with 8
    lanes a side movers are dropped, with 48 none."""
    world, kws, port, ref = _case(both, f"migrate-cap{capx}")
    dropped = 0
    for r in range(world):
        for a, b in zip(port[r][:2], ref[r][:2]):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        assert port[r][2] == int(ref[r][2])
        dropped += port[r][2]
    assert (dropped > 0) == (capx == 8), dropped
    # Every live particle is somewhere: kept, shipped or parked.
    live = sum(int((p[0][PM] > 0).sum()) for p in port)
    assert live == world * int((kws[0]["rows"][PM] > 0).sum())


@pytest.mark.parametrize("tag", sorted(HALO_X))
def test_halo_exchange_x_matches_jax_bit_for_bit(both, tag):
    world, kws, port, ref = _case(both, f"halo_x-{tag}")
    for r in range(world):
        np.testing.assert_array_equal(_bits(port[r]), _bits(ref[r]))
    # The first plane of rank 1 took rank 0's overhang.
    p2 = kws[0]["p2"]
    first = kws[1]["grid"][WX * p2:(WX + 1) * p2] + kws[0]["grid"][WX * p2:(WX + 1) * p2]
    np.testing.assert_array_equal(port[1][WX * p2:(WX + 1) * p2], first)


@pytest.mark.parametrize("cap", SPARSE_CAPS)
def test_halo_exchange_sparse_matches_jax_bit_for_bit(both, cap):
    """Grids and halo_dropped equal JAX's; the ghost slot stays zero though
    keys the owner lacks were shipped; with halo_cap 3 planes overflow."""
    world, kws, port, ref = _case(both, f"halo_sparse-cap{cap}")
    dropped = 0
    for r in range(world):
        np.testing.assert_array_equal(_bits(port[r][0]), _bits(ref[r][0]))
        assert port[r][1] == ref[r][1]
        assert not port[r][0][AMAX].any()
        dropped += port[r][1]
    assert (dropped > 0) == (cap == 3), dropped
    # Some shipped overhang key is absent on its owner (routed to the ghost).
    absent = 0
    for r in range(world - 1):
        hi = kws[r]["hi_key"]
        sent = {int(k) for k in kws[r]["act"] if hi <= k < bk.SPARSE_SENTINEL}
        absent += len(sent - {int(k) for k in kws[r + 1]["act"]})
    assert absent > 0
