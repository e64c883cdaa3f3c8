"""Kernel I's premise and output contract (csrc/g2p2d.cu) against the JAX
package's 2D G2P (Pallas in interpret mode on the CPU), on the small 2D
scenes of tests/test_torch_2d_kernels.py where gated and ungated jobs lie
side by side (the sand column lowered into its floor, the elastic blocks
as built):

- a particle of an ungated job is read only through its position rows:
  its velocity, normal and affinity rows change nothing, in JAX's
  `g2p_rows` or the port's `g2p_plain`; the same change on the lanes of a
  gated job does change them;
- the live jobs of the job table (build_jobs) are its first slots and
  cover the lanes [0, end) in one run, with a full table and with one too
  small (a job-table overflow drops a tail of slots); no lane outside the
  jobs is given a value: the port writes 0 there, and JAX's kernel writes
  nothing there but 0 (interpret mode leaves a lane it never writes NaN);
  rows 6-7 are 0 everywhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from wgsparkl_tpu.ops import pallas_transfer2d as ptf
from wgsparkl_tpu_torch.ops import blocked as bk
from wgsparkl_tpu_torch.ops import rows2d as R2
from wgsparkl_tpu_torch.ops.transfer2d import g2p_plain


# Scenes with both gate levels among their live jobs.
CASES = [("sand_column", "in_floor"), ("elastic_blocks", "as_built")]


def _dump(scene, placement):
    return H.jax_dump_2d(scene, H.SHIFTS_2D[placement])


def _g2p(data, d, pdata, m=None):
    """(JAX g2p_rows, port g2p_plain) [8, NPAD + G + 128] on the dump's
    substep with the particle rows pdata and the first m job slots."""
    cfg = data.config
    m = len(d["len"]) if m is None else m
    nt = d["ntiles"][:m]
    itiles = np.stack([(nt[..., 1].astype(np.int32) << 16) | nt[..., 0].astype(np.int32),
                       nt[..., 2].astype(np.int32)], -1)
    jobs = {k: d[k][:m] for k in ("start", "len", "block")}
    npad, nc = d["rows"].shape[1], cfg.num_colliders
    ref = ptf.g2p_rows(jnp.asarray(pdata), jnp.asarray(d["ftiles"][:m]),
                       jnp.asarray(itiles), jnp.asarray(d["btable"]),
                       {k: jnp.asarray(v) for k, v in jobs.items()},
                       jnp.asarray(d["bcells"][:m]), cfg.grid, cfg.group, npad, nc,
                       jnp.asarray(d["jbody"][:m]))
    out = g2p_plain(H.to_torch(pdata), H.to_torch(d["ftiles"][:m]), H.to_torch(nt),
                    H.to_torch(d["btable"]), {k: H.to_torch(v) for k, v in jobs.items()},
                    H.to_torch(d["bcells"][:m]).to(torch.int32),
                    H.to_torch(d["jbody"][:m]), cfg.grid.cell_width, cfg.group, npad, nc)
    return np.asarray(ref), out.numpy()


def _lanes(d, gated: bool):
    """Lanes of the live jobs whose gate level is (gated) > 0 or 0."""
    lanes = [np.arange(s, s + n) for s, n, g in zip(d["start"], d["len"], d["jbody"])
             if n > 0 and (g > 0) == gated]
    return np.concatenate(lanes)


def _perturbed(d, lanes, seed):
    """The dump's pdata with the velocity, normal and affinity rows of
    `lanes` replaced by other values (affinity halves stay 16-bit
    integers)."""
    rng = np.random.default_rng(seed)
    pdata = d["pdata"].copy()
    for r in (R2.VX, R2.VY, R2.NX, R2.NY):
        pdata[r, lanes] = rng.standard_normal(len(lanes)).astype(np.float32) * 3.0
    for r in (R2.AFF, R2.AFF_SPARE):
        pdata[r, lanes] = rng.integers(0, 2 ** 16, len(lanes)).astype(np.float32)
    return pdata


@pytest.mark.parametrize("scene,placement", CASES)
def test_ungated_job_reads_only_positions(scene, placement):
    data, d = _dump(scene, placement)
    ref0, out0 = _g2p(data, d, d["pdata"])
    lanes = _lanes(d, gated=False)
    assert len(lanes) > 50
    ref, out = _g2p(data, d, _perturbed(d, lanes, 1))
    np.testing.assert_array_equal(ref, ref0)        # NaN where JAX never writes
    np.testing.assert_array_equal(out, out0)


@pytest.mark.parametrize("scene,placement", CASES)
def test_gated_job_reads_its_rows(scene, placement):
    data, d = _dump(scene, placement)
    ref0, out0 = _g2p(data, d, d["pdata"])
    lanes = _lanes(d, gated=True)
    assert len(lanes) > 20
    ref, out = _g2p(data, d, _perturbed(d, lanes, 2))
    for a, b in ((ref, ref0), (out, out0)):
        changed = (a[:6, lanes] != b[:6, lanes]).any(0)
        assert changed.sum() > len(lanes) // 4


@pytest.mark.parametrize("scene,placement", CASES)
@pytest.mark.parametrize("table", ["full", "overflow"])
def test_lanes_outside_jobs(scene, placement, table):
    data, d = _dump(scene, placement)
    cfg = data.config
    nb_total = int(np.prod(bk.num_blocks(cfg.grid)))
    live = int((d["len"] > 0).sum())
    max_jobs = cfg.max_jobs if table == "full" else live * 2 // 3
    # build_jobs' table: the live jobs are its first slots, in one run of
    # lanes from 0; an overflowing table is the full one's first slots.
    jobs = bk.build_jobs(H.to_torch(d["sorted_ids"]), nb_total, cfg.group, max_jobs)
    start, ln = jobs["start"].numpy(), jobs["len"].numpy()
    m = int((ln > 0).sum())
    assert (ln[:m] > 0).all() and (ln[m:] == 0).all()
    assert start[0] == 0 and (start[1:m] == start[:m - 1] + ln[:m - 1]).all()
    np.testing.assert_array_equal(start[:m], d["start"][:m])
    np.testing.assert_array_equal(ln, d["len"][:max_jobs])
    assert (m < live) == (table == "overflow")
    end = int(start[m - 1] + ln[m - 1])
    ref, out = _g2p(data, d, d["pdata"], max_jobs)
    assert (out[:, end:] == 0).all() and (out[6:] == 0).all()
    outside = ref[:, end:]
    assert ((outside == 0) | np.isnan(outside)).all() and np.isnan(outside).any()
    assert (ref[6:, :end] == 0).all()
    # Covered lanes: f32 roundoff of 9-node sums taken in another order.
    np.testing.assert_allclose(out[:6, :end], ref[:6, :end], rtol=0, atol=1e-5)
