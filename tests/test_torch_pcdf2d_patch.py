"""Kernel G's in-place patch of the sorted particle rows (ops/transfer2d.py
`pcdf_rows` / `pcdf_plain`, and pipeline._substep_2d, which hands G its
fresh sorted rows), on the CPU through the plain version, in the
gathered, dense (moving collider) and chan-free 2D modes:

- G reads no row that it only writes: the particle-CDF rows and the
  patched rows do not depend on what rows NX and NY held;
- the patched rows equal a clone-and-copy reference, the 16 transfer rows
  cloned with rows AFF, NX, NY, AFF_SPARE copied in from the particle-CDF
  rows, bit for bit, and the rows past the 16 are untouched;
- a 2D substep's record keeps G's input as `rows` and the patched view as
  `pdata`;
- against the JAX package (kernels in interpret mode on the CPU), the
  patched rows equal its `dynamic_update_slice` of the particle CDF into
  pdata, within kernel G's own tolerance, in the gathered and chan-free
  modes (the JAX phase dump `dump_phases_2d` takes 2D scenes whose
  colliders are all static or chan-free ones, not a dense scene with a
  moving collider: in the dense mode the patched rows are held against
  the clone-and-copy reference above, and on the card against the plain
  version).

The scenes are the small sand column (24 x 48 particles, cell width 0.5,
group 128) lowered 1.5 cells into its floor, its positions and velocities
jittered from a numpy seed, alone or stirred by a kinematic ball and
capsule."""

import functools

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from wgsparkl_tpu_torch import scenes
from wgsparkl_tpu_torch.collision.shapes import Collider
from wgsparkl_tpu_torch.ops import rows2d as R2
from wgsparkl_tpu_torch.ops import transfer2d
from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc, step_pallas

torch.set_num_threads(2)

MODES = ("gathered", "dense", "chan_free")
PATCHED = [R2.AFF, R2.NX, R2.NY, R2.AFF_SPARE]


def _scene(mode: str, seed: int = 10) -> MpmData:
    d = scenes.sand_column_2d(nx=24, ny=48, cell_width=0.5, group=128, device="cpu")
    p = d.state.particles
    rng = np.random.default_rng(seed)
    p.pos += torch.as_tensor(rng.uniform(-0.05, 0.05, (p.count, 2)),
                             dtype=torch.float32) + torch.tensor([0.0, -0.75])
    p.vel += torch.as_tensor(rng.normal(0.0, 0.5, (p.count, 2)), dtype=torch.float32)
    if mode == "gathered":
        return d
    bodies = list(d.bodies_desc) + [
        RigidBodyDesc(Collider.ball(0.8), (-1.5, 1.5), body_type="kinematic",
                      angvel=1.0),
        RigidBodyDesc(Collider.capsule(1.0, 0.3), (1.5, 1.2), rotation=1.2,
                      body_type="kinematic", angvel=-1.0)]
    return MpmData(d.params, p, d.state.models, bodies, 0.5, grid=d.config.grid,
                   group=128, chan_free=mode == "chan_free")


@functools.lru_cache(maxsize=None)
def _record(mode: str):
    """(config, record of the substep after 2 substeps) of the mode's scene."""
    d = _scene(mode)
    cfg = d.config
    assert cfg.chan_free == (mode == "chan_free")
    assert cfg.static_slots == (0,)
    assert (mode == "gathered") == (cfg.num_colliders == 1)
    state = step_pallas(d.state, d.params, cfg, 2)
    rec = {}
    step_pallas(state, d.params, cfg, 1, record=rec)
    live = rec["jobs"]["len"] > 0
    gates = rec["jbody"][live]
    assert int((gates > 0).sum()) > 3 and bool((gates == 0).any())
    return cfg, rec


def _args(cfg, rec):
    """Kernel G's arguments as the 2D substep passes them, on a copy of the
    recorded rows (G patches them in place)."""
    return (rec["rows"].clone(), rec["ntiles"], rec["jobs"], rec["bcells"], rec["jbody"],
            cfg.grid.cell_width, cfg.group, rec["rows"].shape[1], cfg.num_colliders,
            rec["btable"], rec["alldesc"], cfg.chan_free)


def _clone_and_copy(rows, pcdf):
    """The patched pdata stated as a clone and copies: the 16 transfer rows
    cloned, rows AFF, NX..NY and AFF_SPARE copied in from G's output."""
    npad = rows.shape[1]
    pdata = rows[:R2.NCHAN].clone()
    pdata[R2.AFF] = pcdf[0, :npad]
    pdata[R2.NX:R2.NY + 1] = pcdf[2:4, :npad]
    pdata[R2.AFF_SPARE] = pcdf[4, :npad]
    return pdata


@pytest.mark.parametrize("fn", ["pcdf_plain", "pcdf_rows"])
@pytest.mark.parametrize("mode", MODES)
def test_written_rows_are_not_read(mode, fn):
    """The same particle-CDF rows and patched rows, bit for bit, whatever
    rows NX and NY held (NaN, or the record's), and on a second call on
    fresh rows."""
    cfg, rec = _record(mode)
    args = _args(cfg, rec)
    f = getattr(transfer2d, fn)
    ref = f(*args)
    assert int((ref[0] != 0).sum()) > 20
    for fill in (None, float("nan")):
        rows = rec["rows"].clone()
        if fill is not None:
            rows[R2.NX:R2.NY + 1] = fill
        assert torch.equal(f(rows, *args[1:]), ref)
        assert torch.equal(rows, args[0])


@pytest.mark.parametrize("mode", MODES)
def test_patched_rows_equal_clone_and_copy(mode):
    """The rows patched in place equal the clone-and-copy reference bit for
    bit, and the rows past the 16 are untouched."""
    cfg, rec = _record(mode)
    args = _args(cfg, rec)
    rows = args[0]
    pcdf = transfer2d.pcdf_plain(*args)
    ref = _clone_and_copy(rec["rows"], pcdf)
    assert not torch.equal(ref, rec["rows"][:R2.NCHAN])
    assert torch.equal(rows[:R2.NCHAN], ref)
    assert torch.equal(rows[R2.NCHAN:], rec["rows"][R2.NCHAN:])


@pytest.mark.parametrize("mode", MODES)
def test_record_keeps_kernel_g_input(mode):
    """After a 2D substep, record["rows"] is G's input (the sorted rows as
    permuted, before the patch), record["pdata"] the patched rows, and
    record["pcdf"] G's output on record["rows"]."""
    cfg, rec = _record(mode)
    rows = rec["rows"]
    assert torch.equal(rows, rec["unsorted"][:, rec["perm"].to(torch.int64)])
    args = _args(cfg, rec)
    assert torch.equal(rec["pcdf"], transfer2d.pcdf_plain(*args))
    assert torch.equal(rec["pdata"], args[0][:R2.NCHAN])
    assert torch.equal(rec["pdata"], _clone_and_copy(rows, rec["pcdf"]))
    assert not torch.equal(rec["pdata"][PATCHED], rows[PATCHED])


def _jax_case(case):
    if case == "gathered":
        data, d = H.jax_dump_2d("sand_column", H.SHIFTS_2D["in_floor"])
    else:
        data, d = H.dump_phases_2d(H.jax_scene_2d_moving(chan_free=True))
    cfg = data.config
    assert cfg.chan_free == (case == "chan_free")
    alldesc = tuple(enumerate(cfg.collider_types))
    args = ((H.to_torch(d["rows"]), H.to_torch(d["ntiles"])) + H.port_jobs(d)
            + (cfg.grid.cell_width, cfg.group, d["rows"].shape[1], cfg.num_colliders,
               H.to_torch(d["btable"]), alldesc, cfg.chan_free))
    return d, args


@pytest.mark.parametrize("case", ["gathered", "chan_free"])
def test_patched_rows_match_jax(case):
    """The rows patched in place against the JAX substep's pdata (its
    dynamic_update_slice of the particle CDF): the unpatched rows and the
    affinity halves bit for bit, the normal within kernel G's tolerance
    against JAX (test_torch_2d_kernels.test_pcdf2d_matches_jax) on the
    covered lanes; past them the port's patched rows are 0, and JAX's 0 or
    NaN (interpret mode leaves lanes its kernel never writes NaN)."""
    d, args = _jax_case(case)
    transfer2d.pcdf_rows(*args)
    got, ref = args[0][:R2.NCHAN].numpy(), d["pdata"]
    ce = int(d["covered_end"])
    keep = [r for r in range(R2.NCHAN) if r not in PATCHED]
    np.testing.assert_array_equal(got[keep], ref[keep])
    np.testing.assert_array_equal(got[[R2.AFF, R2.AFF_SPARE], :ce],
                                  ref[[R2.AFF, R2.AFF_SPARE], :ce])
    assert (ref[R2.AFF, :ce] != 0).sum() > 20
    np.testing.assert_allclose(got[R2.NX:R2.NY + 1, :ce], ref[R2.NX:R2.NY + 1, :ce],
                               rtol=0, atol=5e-4)
    assert not got[PATCHED, ce:].any()
    tail = ref[PATCHED, ce:]
    assert np.all((tail == 0) | np.isnan(tail))
