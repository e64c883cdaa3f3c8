"""The premises of the kernel F and kernel C (3D) designs, on the CPU with
the port's plain versions, inputs made with numpy from a seed.

- Kernel C runs one SVD where its plain version runs three: the fracture
  check computed from svd3x3_ch's |sigma| equals the plain check on
  eig33_sigma_ch's values bit for bit, and drucker_prager_project_ch
  returns its input F bit for bit on every lane where it does not apply,
  so the stress may reuse the first SVD there.
- Kernel F sums in kernel A's P2G form and lists order: at nc = 0 with every
  job at gate level 0 its plain tiles equal the P2G half of kernel A's plain
  version bit for bit on the same jobs."""

import numpy as np
import pytest
import torch

from wgsparkl_tpu_torch.math.svd import det3_ch, eig33_sigma_ch, svd3x3_ch
from wgsparkl_tpu_torch.models.drucker_prager import (
    DruckerPrager, drucker_prager_arrays, drucker_prager_project_ch,
)
from wgsparkl_tpu_torch.ops import ablation
from wgsparkl_tpu_torch.ops import rows as R
from wgsparkl_tpu_torch.ops.p2g import p2g_plain
from wgsparkl_tpu_torch.ops.p2g_cdf import p2g_cdf_plain
from wgsparkl_tpu_torch.ops.particle_update import _fracture_3d

torch.set_num_threads(2)

N = 4000


def _rotations(rng, n):
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    return q * np.sign(np.linalg.det(q))[:, None, None]


def _from_sigma(rng, sig):
    """U diag(sig) V^T with random rotations U, V."""
    u, v = _rotations(rng, len(sig)), _rotations(rng, len(sig))
    return np.einsum("nij,nj,nkj->nik", u, sig, v)


def _deformations(kind: str) -> np.ndarray:
    rng = np.random.default_rng(["near_identity", "inverted", "rank_deficient",
                                 "identity", "reflection", "tied", "scaled"].index(kind))
    if kind == "near_identity":
        f = np.eye(3) + rng.normal(scale=1e-3, size=(N, 3, 3))
    elif kind == "inverted":
        f = _from_sigma(rng, rng.uniform(0.5, 1.5, (N, 3))) @ np.diag([1.0, 1.0, -1.0])
    elif kind == "rank_deficient":
        sig = rng.uniform(0.5, 1.5, (N, 3))
        sig[:, 2] = 0.0
        sig[: N // 2, 1] = 0.0
        f = _from_sigma(rng, sig)
    elif kind == "identity":
        f = np.broadcast_to(np.eye(3), (N, 3, 3))
    elif kind == "reflection":
        f = np.broadcast_to(np.diag([1.0, -1.0, 1.0]), (N, 3, 3)).copy()
        f[N // 2:] = np.diag([-1.0, -1.0, -1.0])
    elif kind == "tied":
        sig = np.repeat(rng.uniform(0.8, 1.2, (N, 1)), 3, axis=1)
        sig[N // 2:, 2] = rng.uniform(0.8, 1.2, N - N // 2)
        f = _from_sigma(rng, sig)
    else:
        f = rng.normal(size=(N, 3, 3)) * rng.uniform(0.1, 3.0, (N, 1, 1))
    return np.ascontiguousarray(f, dtype=np.float32)


def _channels(f):
    t = torch.as_tensor(f)
    return {(i, j): t[:, i, j].contiguous() for i in range(3) for j in range(3)}


def _over_from_svd(sig, detf, stretch):
    """Kernel C's fracture test on the signed SVD's |sigma|: sign(det F)
    goes to every value equal to the least."""
    sg = [s.abs() for s in sig]
    smin = torch.minimum(torch.minimum(sg[0], sg[1]), sg[2])
    sgn = torch.where(detf < 0.0, -1.0, 1.0)
    over = None
    for s in sg:
        o = s * torch.where(s == smin, sgn, 1.0) > stretch
        over = o if over is None else over | o
    return over


@pytest.mark.parametrize("kind", ["near_identity", "inverted", "rank_deficient",
                                  "identity", "reflection", "tied", "scaled"])
def test_fracture_from_one_svd_equals_eig33_check(kind):
    fc = _channels(_deformations(kind))
    eig = torch.stack(eig33_sigma_ch(fc))
    _, sig, _ = svd3x3_ch(fc)
    # The same sweeps of the same F^T F: the same values in another order.
    assert torch.equal(torch.sort(eig, 0).values,
                       torch.sort(torch.stack(sig).abs(), 0).values)
    detf = det3_ch(fc)
    # Thresholds at, between and around the values themselves.
    vals = torch.unique(eig)
    for stretch in [vals[0], vals[len(vals) // 2], vals[-1], vals.mean(),
                    torch.tensor(1.0), torch.tensor(1.0 + 1e-3)]:
        stretch = stretch.expand_as(detf)
        want = _fracture_3d(fc, {"stretch": stretch})
        assert torch.equal(_over_from_svd(sig, detf, stretch), want)


@pytest.mark.parametrize("kind", ["near_identity", "scaled"])
def test_drucker_prager_keeps_f_where_it_does_not_apply(kind):
    """Lanes the return map leaves alone (disabled plasticity, inside the
    cone) get their input F back bit for bit: kernel C reuses its SVD there."""
    fc = _channels(_deformations(kind))
    rng = np.random.default_rng(7)
    sand, elastic = DruckerPrager.new(1.0e6, 0.3), DruckerPrager()
    arrays = drucker_prager_arrays([sand, elastic])
    pick = rng.integers(0, 2, N)
    params = {k: torch.as_tensor(v[pick]) for k, v in arrays.items()}
    state = {"det": torch.ones(N), "hardening": torch.zeros(N),
             "log_vol_gain": torch.as_tensor(rng.normal(scale=0.01, size=N)
                                             .astype(np.float32))}
    new_state, new_fc = drucker_prager_project_ch(params, state, fc)
    # Where it applies, the hardening grows by a positive amount.
    kept = new_state["hardening"] == state["hardening"]
    assert bool(kept[params["lam"] <= 0.0].all())
    assert 0 < int(kept.sum()) < N
    for k in fc:
        assert torch.equal(new_fc[k][kept], fc[k][kept])
    assert torch.equal(new_state["det"][kept], state["det"][kept])
    assert torch.equal(new_state["log_vol_gain"][kept], state["log_vol_gain"][kept])


@pytest.mark.parametrize("group,n,nlive,affine",
                         [(1024, 3000, 4, False), (1024, 3000, 4, True),
                          (2048, 3400, 2, True)],
                         ids=["probe", "affine", "two_chunks"])
def test_p2g_plain_is_p2g_cdf_plain_at_gate_level_0(group, n, nlive, affine):
    """The probe's jobs (two_chunks: jobs of 1700 particles, two list
    chunks each), with nonzero affine rows of a substep's size."""
    pdata, starts, lens, bcells = ablation.probe_inputs(
        n=n, group=group, maxj=nlive + 2, nlive=nlive, device="cpu")
    if affine:
        rng = np.random.default_rng(3)
        pdata[7:16, :n] = torch.as_tensor(
            rng.normal(size=(9, n)).astype(np.float32) * 0.01)
    by, maxj = ablation.BY, nlive + 2
    _, _, wpad = R.window_geom(by)
    npad = pdata.shape[1] - group - 128
    jobs = {"start": starts, "len": lens}
    jbody = torch.zeros(maxj, dtype=torch.int32)
    btable = torch.zeros((32, 128))
    mm_f, imp_f = p2g_plain(pdata, torch.zeros((1, wpad, 4)), btable, jobs, bcells,
                            jbody, 1.0, by, 0)
    mm_a, _, _ = p2g_cdf_plain(pdata, torch.zeros((maxj, wpad, 4)), btable, jobs,
                               bcells, jbody, 1.0, by, group, npad, 0, ())
    assert float(mm_f[..., 3].sum()) > 0.0 and not imp_f.any()
    assert torch.equal(mm_f, mm_a)
