"""The CUDA kernels against their plain PyTorch versions on the card: the
3D path's five on the recorded inputs of one substep of the coupled sand
box lowered onto the paddle (so kernel A's impulse path carries load), the
2D path's four on a substep of each small 2D scene lowered into its floor
(so kernel H's impulses carry load), kernel F on a substep of the spinning
collider-free sand box and on the coupled inputs, kernel C's neo-Hookean
branch in 3D and 2D, the math probe and every core of the P2G ablation
probe; the `fold_vel` branches of B and I on folded substeps, the 2D
chan-free branches of G, H and I on the stirred column, H on jobs that
span several of its chunks, and the rigid solve on a substep of a small
sand2 with its plates pressed into the floor and each other and of a 3D
plate on a ball joint, the mesh pass on a substep of each small mesh
scene of chip_smoke.py, A (or F), B, C and the slot-addressed mesh
pass on its small sparse scenes, and the dense transfer's kernels with C
in its centred mode, 2D and 3D, with and without the blocked transfer's
lane mask.  Marked `cuda`: they skip where
torch sees no CUDA device (run them on a GPU host with
`python -m pytest --noconftest tests/test_torch_cuda_kernels.py`)."""

import dataclasses

import numpy as np
import pytest
import torch

from wgsparkl_tpu_torch import scenes
from wgsparkl_tpu_torch.math import probe
from wgsparkl_tpu_torch.ops import (
    ablation, compact, g2p, p2g, p2g_cdf, permute, transfer2d, update_rows,
)
from wgsparkl_tpu_torch.ops import rows as R
from wgsparkl_tpu_torch.ops import rows2d as R2
from wgsparkl_tpu_torch.pipeline import MpmData, step_pallas

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def rec():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = scenes.sand_box_3d(nxz=8, ny=16, by=8, group=256, device="cuda")
    # Lattice lowered onto the paddle: gated jobs with CPIC impulses.
    d.state.particles.pos += torch.tensor([0.0, -3.0, 0.0], device="cuda")
    state = step_pallas(d.state, d.params, d.config, 2)
    r = {}
    step_pallas(state, d.params, d.config, 1, record=r)
    r["cfg"], r["dt"] = d.config, d.params.dt
    return r


def _close(a, b, rtol):
    assert float((a - b).abs().max()) <= rtol * max(1.0, float(b.abs().max()))


def test_p2g_cdf_kernel_matches_plain(rec):
    cfg = rec["cfg"]
    args = (rec["rows"][:24].contiguous(), rec["ntiles"], rec["btable"],
            rec["jobs"], rec["bcells"], rec["jbody"], cfg.grid.cell_width,
            cfg.by, cfg.group, rec["rows"].shape[1], cfg.num_colliders,
            rec["moving"])
    k, p = p2g_cdf.p2g_cdf_tiles(*args), p2g_cdf.p2g_cdf_plain(*args)
    assert float(p[1].abs().max()) > 1.0
    assert torch.equal(k[2][[0, 5]], p[2][[0, 5]])
    # The window tiles: every node's pairs in the lists order, bit for bit.
    assert torch.equal(k[0], p[0])
    _close(k[1], p[1], 1e-4)
    _close(k[2], p[2], 1e-5)
    # Fixed summation order: a second launch gives the same bits.
    k2 = p2g_cdf.p2g_cdf_tiles(*args)
    assert all(torch.equal(a, b) for a, b in zip(k, k2))


def test_g2p_kernel_matches_plain(rec):
    cfg = rec["cfg"]
    args = (rec["pdata"], rec["ftiles"], rec["ntiles"], rec["btable"],
            rec["jobs"], rec["bcells"], rec["jbody"], cfg.grid.cell_width,
            cfg.by, cfg.group, rec["rows"].shape[1], cfg.num_colliders,
            rec["moving"])
    k, p = g2p.g2p_rows(*args), g2p.g2p_plain(*args)
    assert torch.equal(k, p)
    assert torch.equal(k, g2p.g2p_rows(*args))


@pytest.fixture(scope="module", params=["gathered", "chan_free"])
def rec_shapes(request):
    """A substep of the analytic-shapes scene (static halfspace and walls,
    kinematic capsule and ball), the lattice lowered onto the capsule, in
    each CDF mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from wgsparkl_tpu_torch.collision.shapes import Collider
    from wgsparkl_tpu_torch.pipeline import RigidBodyDesc

    d = scenes.sand_box_3d(nxz=8, ny=16, with_paddle=False, device="cuda")
    bodies = ([RigidBodyDesc(Collider.halfspace(), (0.0, 0.0, 0.0))]
              + list(d.bodies_desc[1:5])
              + [RigidBodyDesc(Collider.capsule(28.0, 1.5), (0.0, 2.0, 0.0),
                               rotation=(np.pi / 2, 0.0, 0.0), body_type="kinematic",
                               angvel=(0.0, -1.0, 0.0)),
                 RigidBodyDesc(Collider.ball(2.5), (2.0, 2.0, 2.0),
                               body_type="kinematic", angvel=(0.0, 1.0, 0.0))])
    p = d.state.particles
    p = dataclasses.replace(p, pos=p.pos + torch.tensor([0.0, -3.0, 0.0], device="cuda"))
    d = MpmData(d.params, p, d.state.models, bodies, 1.0, grid=d.config.grid, by=8,
                group=256, chan_free=request.param == "chan_free")
    state = step_pallas(d.state, d.params, d.config, 2)
    r = {}
    step_pallas(state, d.params, d.config, 1, record=r)
    r["cfg"] = d.config
    return r


def test_shapes_kernels_match_plain(rec_shapes):
    """A and B with ball, capsule and halfspace colliders, gathered or
    chan-free: bit for bit but for A's impulses."""
    r, cfg = rec_shapes, rec_shapes["cfg"]
    common = (r["btable"], r["jobs"], r["bcells"], r["jbody"], cfg.grid.cell_width,
              cfg.by, cfg.group, r["rows"].shape[1], cfg.num_colliders, r["moving"],
              r["static_desc"], r["chan_free"])
    args = (r["rows"][:24].contiguous(), r["ntiles"]) + common
    k, p = p2g_cdf.p2g_cdf_tiles(*args), p2g_cdf.p2g_cdf_plain(*args)
    assert float(p[1].abs().max()) > 1.0
    assert torch.equal(k[0], p[0]) and torch.equal(k[2], p[2])
    _close(k[1], p[1], 1e-4)
    args = (r["pdata"], r["ftiles"], r["ntiles"]) + common
    assert torch.equal(g2p.g2p_rows(*args), g2p.g2p_plain(*args))


def test_update_rows_kernel_matches_plain(rec):
    cfg = rec["cfg"]
    nb = rec["grid_mm"].shape[0] - 1
    args = (rec["rows"], rec["krows"], rec["pcdf"], rec["sorted_ids"],
            rec["covered_end"], rec["btable"], rec["mtable"], rec["dt"],
            cfg.grid.cell_width, cfg.num_colliders, cfg.n_materials, nb)
    k, p = update_rows.update_rows(*args), update_rows.update_plain(*args)
    for r in (16, 20, 21, 22):
        assert torch.equal(k[r], p[r])
    for r in range(k.shape[0]):
        _close(k[r], p[r], 1e-4)


def test_permute_kernel_is_exact_on_ragged_lanes():
    """Lane counts that are not a multiple of the kernel's 4-lane groups
    take its scalar loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(0)
    for npad in (1001, 4096):
        rows = torch.randn((5, npad), generator=g).cuda()
        perm = torch.randperm(npad, generator=g).to(torch.int32).cuda()
        assert torch.equal(permute.permute_lanes(rows, perm),
                           permute.permute_plain(rows, perm))


def _compact_exact(vals, flag, cap):
    k, p = (compact.compact_flagged(vals, flag, cap),
            compact.compact_plain(vals, flag, cap))
    assert torch.equal(k[0], p[0]) and bool(k[1]) == bool(p[1])
    again = compact.compact_flagged(vals, flag, cap)
    assert torch.equal(k[0], again[0]) and bool(k[1]) == bool(again[1])


def test_permute_and_compact_kernels_are_exact(rec):
    assert torch.equal(permute.permute_lanes(rec["unsorted"], rec["perm"]),
                       permute.permute_plain(rec["unsorted"], rec["perm"]))
    sids = rec["sorted_ids"]
    flag = torch.ones_like(sids, dtype=torch.bool)
    flag[1:] = sids[1:] != sids[:-1]
    vals = sids.to(torch.float32)[None]
    for cap in (4, 4096):
        _compact_exact(vals, flag, cap)
    # Kernel E's edge cases (tests/test_torch_permute_compact.py's, and a
    # million lanes): N a multiple of 1024 and not, below one 16384-lane
    # tile and over 61 of them, no flag, every flag, more flags than cap,
    # R = 0 (the index row only, as the sparse job table takes it), 1 and
    # 2, and a flag view that starts off a 16-byte boundary.
    rng = np.random.default_rng(6)
    for density, n, cap, r in ((0.01, 8192, 300, 2), (0.05, 8192, 300, 2),
                               (0.0, 8192, 300, 2), (1e-3, 10_000, 300, 1),
                               (0.05, 700, 300, 2), (1.0, 3000, 4000, 2),
                               (0.05, 8192, 100, 1), (1.0, 5000, 1000, 1),
                               (1e-3, 1_000_003, 9000, 1), (1.0, 1_000_003, 20_000, 2),
                               (1e-3, 1_000_003, 2688, 0), (0.05, 8192, 100, 0)):
        vals = torch.as_tensor(rng.integers(0, 2 ** 24, (r, n)).astype(np.float32))
        flag = torch.as_tensor(rng.random(n) < density)
        _compact_exact(vals.cuda(), flag.cuda(), cap)
    flag = torch.as_tensor(rng.random(5001) < 0.3).cuda()[1:]
    _compact_exact(torch.arange(5000, dtype=torch.float32, device="cuda")[None], flag,
                   6000)


@pytest.fixture(scope="module", params=["sand_column", "elastic_blocks"])
def rec2d(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if request.param == "sand_column":
        d = scenes.sand_column_2d(nx=24, ny=48, cell_width=0.5, group=128,
                                  device="cuda")
    else:
        d = scenes.elastic_blocks_2d(n_side=24, cell_width=0.5, group=128,
                                     device="cuda")
    # Lattice lowered 1.5 cells: the bottom rows start inside the floor.
    d.state.particles.pos += torch.tensor([0.0, -0.75], device="cuda")
    state = step_pallas(d.state, d.params, d.config, 2)
    r = {}
    step_pallas(state, d.params, d.config, 1, record=r)
    r["cfg"], r["dt"] = d.config, d.params.dt
    return r


def _jobs2d(r):
    return (r["jobs"], r["bcells"], r["jbody"], r["cfg"].grid.cell_width)


def _nan_empty(monkeypatch):
    """torch.empty gives NaN-filled float tensors: a kernel that owns its
    output must write every entry of it."""
    empty = torch.empty

    def nan_empty(*a, **k):
        t = empty(*a, **k)
        return t.fill_(float("nan")) if t.is_floating_point() else t

    monkeypatch.setattr(torch, "empty", nan_empty)


def _cut_jobs(args, m, tiles):
    """args with the job table cut to its first m slots: the tiles at the
    positions `tiles` (chan-free's one dummy node tile uncut), and the jobs
    dict, block cells and gate levels that follow the last of them (with
    the body table between them in kernel I's arguments)."""
    a = list(args)
    for i in tiles:
        a[i] = a[i] if a[i].shape[0] == 1 else a[i][:m]
    at = next(i for i, v in enumerate(a) if isinstance(v, dict))
    a[at] = {key: v[:m] for key, v in a[at].items()}
    a[at + 1], a[at + 2] = a[at + 1][:m], a[at + 2][:m]
    return tuple(a)


def _pcdf2d_exact(args, monkeypatch):
    """Kernel G equal to its plain version bit for bit on the particle-CDF
    rows and on the particle rows it patches in place (each on a copy of
    args[0]), on outputs that held NaN; the same bits on a second launch
    whose rows NX and NY, which G only writes, held NaN; the patched rows
    equal to the 16 transfer rows with rows AFF, NX, NY, AFF_SPARE copied
    in from the particle-CDF rows; with the job table as recorded, cut to
    its live slots (no dead slot) and to two thirds of them (a job-table
    overflow)."""
    _nan_empty(monkeypatch)
    live = int((args[2]["len"] > 0).sum())
    assert live < args[2]["len"].shape[0]
    for m in (None, live, live * 2 // 3):
        a = args if m is None else _cut_jobs(args, m, (1,))
        outs = []
        for fn, nan in ((transfer2d.pcdf_rows, False), (transfer2d.pcdf_plain, False),
                        (transfer2d.pcdf_rows, True)):
            rows = a[0].clone()
            if nan:
                rows[R2.NX:R2.NY + 1] = float("nan")
            outs.append((fn(rows, *a[1:]), rows))
        k, p, k2 = outs
        assert int((p[0][0] != 0).sum()) > 0
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
        assert torch.equal(k[0], k2[0]) and torch.equal(k[1], k2[1])
        npad = a[0].shape[1]
        ref = a[0].clone()
        ref[R2.AFF] = p[0][0, :npad]
        ref[R2.NX:R2.NY + 1] = p[0][2:4, :npad]
        ref[R2.AFF_SPARE] = p[0][4, :npad]
        assert torch.equal(p[1], ref)


def test_pcdf2d_kernel_matches_plain(rec2d, monkeypatch):
    r, cfg = rec2d, rec2d["cfg"]
    args = ((r["rows"], r["ntiles"]) + _jobs2d(r)
            + (cfg.group, r["rows"].shape[1], cfg.num_colliders))
    _pcdf2d_exact(args, monkeypatch)


def test_p2g2d_kernel_matches_plain(rec2d):
    r, cfg = rec2d, rec2d["cfg"]
    args = ((r["pdata"], r["ntiles"], r["btable"]) + _jobs2d(r)
            + (cfg.num_colliders,))
    k, p = transfer2d.p2g_tiles(*args), transfer2d.p2g_plain(*args)
    assert float(p[1].abs().max()) > 0.0
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    k2 = transfer2d.p2g_tiles(*args)
    assert torch.equal(k[0], k2[0]) and torch.equal(k[1], k2[1])


def _g2p2d_exact(args, monkeypatch):
    """Kernel I equal to its plain version and to a second launch on the
    whole output, which held NaN, with the job table as recorded, cut to
    its live slots (no dead slot) and to two thirds of them (a job-table
    overflow drops the tail)."""
    _nan_empty(monkeypatch)
    k = transfer2d.g2p_rows(*args)
    assert torch.equal(k, transfer2d.g2p_plain(*args))
    assert torch.equal(k, transfer2d.g2p_rows(*args))
    live = int((args[4]["len"] > 0).sum())
    for m in (live, live * 2 // 3):
        cut = _cut_jobs(args, m, (1, 2))
        assert torch.equal(transfer2d.g2p_rows(*cut), transfer2d.g2p_plain(*cut))


def test_g2p2d_kernel_matches_plain(rec2d, monkeypatch):
    r, cfg = rec2d, rec2d["cfg"]
    args = ((r["pdata"], r["ftiles"], r["ntiles"], r["btable"]) + _jobs2d(r)
            + (cfg.group, r["rows"].shape[1], cfg.num_colliders))
    _g2p2d_exact(args, monkeypatch)


def test_update_rows2d_kernel_matches_plain(rec2d):
    r, cfg = rec2d, rec2d["cfg"]
    nb = r["grid_mm"].shape[0] - 1
    args = (r["rows"], r["krows"], r["pcdf"], r["sorted_ids"],
            r["covered_end"], r["btable"], r["mtable"], r["dt"],
            cfg.grid.cell_width, cfg.num_colliders, cfg.n_materials, nb)
    k, p = update_rows.update_rows2d(*args), update_rows.update2d_plain(*args)
    for row in range(k.shape[0]):
        _close(k[row], p[row], 1e-4)


def test_update_rows_neo_hookean_kernel_matches_plain(rec):
    cfg = rec["cfg"]
    nb = rec["grid_mm"].shape[0] - 1
    args = (rec["rows"], rec["krows"], rec["pcdf"], rec["sorted_ids"],
            rec["covered_end"], rec["btable"], rec["mtable"], rec["dt"],
            cfg.grid.cell_width, cfg.num_colliders, cfg.n_materials, nb)
    k = update_rows.update_rows(*args, elastic_model="neo_hookean")
    p = update_rows.update_plain(*args, elastic_model="neo_hookean")
    for r in (16, 20, 21, 22):
        assert torch.equal(k[r], p[r])
    for r in range(k.shape[0]):
        _close(k[r], p[r], 1e-4)


def test_update_rows2d_neo_hookean_kernel_matches_plain(rec2d):
    r, cfg = rec2d, rec2d["cfg"]
    nb = r["grid_mm"].shape[0] - 1
    args = (r["rows"], r["krows"], r["pcdf"], r["sorted_ids"],
            r["covered_end"], r["btable"], r["mtable"], r["dt"],
            cfg.grid.cell_width, cfg.num_colliders, cfg.n_materials, nb)
    k = update_rows.update_rows2d(*args, elastic_model="neo_hookean")
    p = update_rows.update2d_plain(*args, elastic_model="neo_hookean")
    for row in (9, 12, 13, 14):
        assert torch.equal(k[row], p[row])
    for row in range(k.shape[0]):
        _close(k[row], p[row], 1e-4)


@pytest.fixture(scope="module")
def rec_free():
    """A substep of the sand_box_3d(nxz=8, ny=16) lattice with no body,
    spinning at 1 rad/s about its vertical centre line."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = scenes.sand_box_3d(nxz=8, ny=16, with_paddle=False, device="cuda")
    vel = scenes.spin_velocities(d.state.particles.pos.cpu())
    p = dataclasses.replace(d.state.particles,
                            vel=torch.as_tensor(vel, device="cuda"))
    data = MpmData(d.params, p, d.state.models, [], 1.0, grid=d.config.grid,
                   by=8, group=256)
    state = step_pallas(data.state, data.params, data.config, 2)
    out = {}
    step_pallas(state, data.params, data.config, 1, record=out)
    out["cfg"] = data.config
    return out


def test_p2g_kernel_matches_plain(rec_free):
    """Kernel F at nc = 0: bit for bit, and the same bits twice."""
    r, cfg = rec_free, rec_free["cfg"]
    args = (r["pdata"], r["ntiles"], r["btable"], r["jobs"], r["bcells"],
            r["jbody"], cfg.grid.cell_width, cfg.by, 0)
    k, pl = p2g.p2g_tiles(*args), p2g.p2g_plain(*args)
    assert float(pl[0][..., 3].sum()) > 0.0
    assert torch.equal(k[0], pl[0]) and torch.equal(k[1], pl[1])
    k2 = p2g.p2g_tiles(*args)
    assert torch.equal(k[0], k2[0]) and torch.equal(k[1], k2[1])


def test_p2g_kernel_cpic_branch_matches_plain(rec):
    """Kernel F at nc > 0 on the coupled inputs, the paddle merged into the
    window CDF: compatibility masks and impulses, bit for bit."""
    cfg = rec["cfg"]
    h = cfg.grid.cell_width
    wsh, wvol, _ = R.window_geom(cfg.by)
    naff, closest, dist = R.window_cdf(
        rec["ntiles"], R.window_positions(rec["bcells"], h, wsh), rec["btable"],
        rec["moving"], rec["jbody"], h, wvol)
    tiles = torch.zeros_like(rec["ntiles"])
    tiles[:, :wvol] = torch.stack([*R.aff_halves(naff), closest, dist], -1)
    args = (rec["pdata"], tiles, rec["btable"], rec["jobs"], rec["bcells"],
            rec["jbody"], h, cfg.by, cfg.num_colliders)
    k, pl = p2g.p2g_tiles(*args), p2g.p2g_plain(*args)
    assert float(pl[1].abs().max()) > 1.0
    assert torch.equal(k[0], pl[0]) and torch.equal(k[1], pl[1])


def test_math_probe_kernel_within_4_ulps_of_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, y = probe.probe_inputs("cuda")
    k, pl = probe.math_probe(x, y), probe.math_probe_plain(x, y)
    ratio = (k.double() / pl.double() - 1.0).abs()
    assert float(ratio.max()) <= 4 * 2.0 ** -23
    assert np.isfinite(k.cpu().numpy()).all()


@pytest.mark.parametrize("group,n,nlive", [(1024, 40_000, 52), (2048, 20_000, 12)],
                         ids=["one_chunk", "two_chunks"])
def test_p2g_ablation_cores_match_plain(group, n, nlive):
    """Every core of the probe: the full stage equal to its plain version
    bit for bit and the same bits twice, every stage finite; jobs of 1666
    particles at group 2048 sort in two chunks of 1024."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    inputs = ablation.probe_inputs(n=n, group=group, maxj=nlive + 8, nlive=nlive,
                                   device="cuda")
    for core in ablation.CORES:
        full = ablation.p2g_ablation(*inputs, core=core, group=group)
        assert float(full[..., 3].sum()) > 0.0
        assert torch.equal(full, ablation.p2g_ablation_plain(*inputs, core=core))
        assert torch.equal(full, ablation.p2g_ablation(*inputs, core=core, group=group))
        for stage in ablation.STAGES[:3]:
            out = ablation.p2g_ablation(*inputs, stage=stage, core=core, group=group)
            assert bool(torch.isfinite(out).all())


@pytest.fixture(scope="module", params=[3, 2])
def rec_fold(request):
    """A substep of the small sand box lowered onto the paddle (3D) or the
    sand column lowered into its floor (2D), with fold_vel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if request.param == 3:
        d = scenes.sand_box_3d(nxz=8, ny=16, by=8, group=256, device="cuda",
                               fold_vel=True)
        d.state.particles.pos += torch.tensor([0.0, -3.0, 0.0], device="cuda")
    else:
        d = scenes.sand_column_2d(nx=24, ny=48, cell_width=0.5, group=128,
                                  device="cuda", fold_vel=True)
        d.state.particles.pos += torch.tensor([0.0, -0.75], device="cuda")
    state = step_pallas(d.state, d.params, d.config, 2)
    r = {}
    step_pallas(state, d.params, d.config, 1, record=r)
    r["cfg"] = d.config
    return r


def test_fold_kernels_match_plain(rec_fold, monkeypatch):
    """B (3D) or I (2D) with the grid update folded in: bit for bit."""
    r, cfg = rec_fold, rec_fold["cfg"]
    assert r["fold_vel"]
    if cfg.grid.dim == 3:
        args = (r["pdata"], r["ftiles"], r["ntiles"], r["btable"], r["jobs"],
                r["bcells"], r["jbody"], cfg.grid.cell_width, cfg.by, cfg.group,
                r["rows"].shape[1], cfg.num_colliders, r["moving"], (), False, True)
        assert torch.equal(g2p.g2p_rows(*args), g2p.g2p_plain(*args))
    else:
        args = ((r["pdata"], r["ftiles"], r["ntiles"], r["btable"]) + _jobs2d(r)
                + (cfg.group, r["rows"].shape[1], cfg.num_colliders, (), False, True))
        _g2p2d_exact(args, monkeypatch)


@pytest.fixture(scope="module")
def rec2d_chan_free():
    """A substep of the small sand column stirred by a kinematic ball and
    capsule, in the chan-free CDF mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from wgsparkl_tpu_torch.collision.shapes import Collider
    from wgsparkl_tpu_torch.pipeline import RigidBodyDesc

    d = scenes.sand_column_2d(nx=24, ny=48, cell_width=0.5, group=128, device="cuda")
    bodies = list(d.bodies_desc) + [
        RigidBodyDesc(Collider.ball(0.8), (-1.5, 1.5), body_type="kinematic",
                      angvel=1.0),
        RigidBodyDesc(Collider.capsule(1.0, 0.3), (1.5, 1.2), rotation=1.2,
                      body_type="kinematic", angvel=-1.0)]
    d = MpmData(d.params, d.state.particles, d.state.models, bodies, 0.5,
                grid=d.config.grid, group=128, chan_free=True)
    state = step_pallas(d.state, d.params, d.config, 2)
    r = {}
    step_pallas(state, d.params, d.config, 1, record=r)
    r["cfg"] = d.config
    return r


def test_chan_free_2d_kernels_match_plain(rec2d_chan_free, monkeypatch):
    """G, H and I evaluating every collider at the window nodes of the
    gated jobs: bit for bit."""
    r, cfg = rec2d_chan_free, rec2d_chan_free["cfg"]
    assert r["chan_free"] and int((r["jbody"][r["jobs"]["len"] > 0] > 0).sum()) > 3
    mode = (r["alldesc"], True)
    npad, nc = r["rows"].shape[1], cfg.num_colliders
    args = (r["rows"], r["ntiles"]) + _jobs2d(r) + (cfg.group, npad, nc,
                                                    r["btable"]) + mode
    _pcdf2d_exact(args, monkeypatch)
    args = (r["pdata"], r["ntiles"], r["btable"]) + _jobs2d(r) + (nc,) + mode
    k, p = transfer2d.p2g_tiles(*args), transfer2d.p2g_plain(*args)
    assert float(p[1].abs().max()) > 0.0
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    args = ((r["pdata"], r["ftiles"], r["ntiles"], r["btable"]) + _jobs2d(r)
            + (cfg.group, npad, nc) + mode)
    _g2p2d_exact(args, monkeypatch)


@pytest.fixture(scope="module")
def rec2d_chunks():
    """A substep of the small sand column on cells three times as wide (36
    particles a cell, group 2048), lowered 1.5 cells into its floor: a
    gated job longer than kernel H's chunk of 256 particles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = scenes.sand_column_2d(nx=24, ny=48, cell_width=0.5, device="cuda")
    g = d.config.grid
    lo = [o * g.cell_width for o in g.origin_cell]
    hi = [(o + n) * g.cell_width for o, n in zip(g.origin_cell, g.shape)]
    d = MpmData(d.params, d.state.particles, d.state.models, d.bodies_desc,
                3 * g.cell_width, grid_bounds=(lo, hi), group=2048)
    d.state.particles.pos += torch.tensor([0.0, -2.25], device="cuda")
    state = step_pallas(d.state, d.params, d.config, 2)
    r = {}
    step_pallas(state, d.params, d.config, 1, record=r)
    r["cfg"] = d.config
    return r


def test_p2g2d_kernel_multi_chunk_matches_plain(rec2d_chunks):
    """H summing a job's chunks in order: bit for bit, the same bits twice."""
    r = rec2d_chunks
    live = r["jobs"]["len"] > 0
    assert int(r["jobs"]["len"].max()) > R2.P2G_CHUNK
    assert bool((r["jbody"][live] > 0).any())
    args = ((r["pdata"], r["ntiles"], r["btable"]) + _jobs2d(r)
            + (r["cfg"].num_colliders,))
    k, p = transfer2d.p2g_tiles(*args), transfer2d.p2g_plain(*args)
    assert float(p[1].abs().max()) > 0.0
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    k2 = transfer2d.p2g_tiles(*args)
    assert torch.equal(k[0], k2[0]) and torch.equal(k[1], k2[1])


@pytest.mark.parametrize("scene", ["sand2_pressed", "plate_joint_3d"])
def test_rigid_solve_kernel_matches_plain(scene):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    from wgsparkl_tpu_torch.rigid import solve

    d = (chip_smoke.sand2_scene("cuda", chip_smoke.SAND2_SMALL,
                                plates=chip_smoke.sand2_pressed(48), shift=(0.0, -4.55),
                                group=128)
         if scene == "sand2_pressed" else chip_smoke.plate_joint_3d("cuda"))
    # Eager (record): a frame graph's capture would call the solve again.
    with chip_smoke.captured_rigid_solve() as calls:
        step_pallas(d.state, d.params, d.config, 1, record={})
    assert len(calls) == 1
    k, p = solve.rigid_solve(*calls[0]), solve.rigid_solve_plain(*calls[0])
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert chip_smoke.active_pairs(calls[0][0], calls[0][5])


@pytest.mark.parametrize("scene", ["ramp", "ramp_by8", "tent", "paddle", "blades"])
def test_mesh_cdf_kernel_matches_plain(scene):
    """The mesh pass on a substep of each of chip_smoke.py's small mesh
    scenes: keys and affinity words bit for bit, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    from wgsparkl_tpu_torch.ops import rigid_cdf

    d = {"ramp": lambda: chip_smoke.ramp_scene("cuda"),
         "ramp_by8": lambda: chip_smoke.ramp_scene("cuda", 8),
         "tent": lambda: chip_smoke.tent_scene("cuda"),
         "paddle": lambda: chip_smoke.paddle_scene("cuda"),
         "blades": lambda: chip_smoke.cut3_scene("cuda", 0.2, shift=(0.0, -7.0, 0.0),
                                                 group=64)}[scene]()
    state = step_pallas(d.state, d.params, d.config, 2)
    args = chip_smoke.mesh_inputs(d, state)
    before = rigid_cdf.mesh_node_cdf.launches
    k = rigid_cdf.mesh_node_cdf(*args)
    assert rigid_cdf.mesh_node_cdf.launches == before + 1
    p = rigid_cdf.mesh_node_cdf_plain(*args)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert int((p[0] < rigid_cdf.INF_KEY).sum()) > 10


@pytest.mark.parametrize("scene", ["ramp", "spray", "box_overflow"])
def test_sparse_kernels_match_plain(scene):
    """The sparse domain on chip_smoke.py's small sparse scenes: a
    substep's A (or F), B and C against their plain versions, bit for bit,
    and on the ramp the slot-addressed mesh pass (keys and words, one
    launch a call)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    from wgsparkl_tpu_torch.ops import rigid_cdf

    d = {"ramp": lambda: chip_smoke.ramp_scene("cuda", sparse=True),
         "spray": lambda: chip_smoke.spray_scene("cuda"),
         "box_overflow": lambda: scenes.sand_box_3d(
             nxz=8, ny=16, device="cuda", group=64, sparse=True, kmax=8,
             amax=16)}[scene]()
    cfg = d.config
    state = step_pallas(d.state, d.params, cfg, 2)
    r = {}
    step_pallas(state, d.params, cfg, 1, record=r)
    h, npad, nc = cfg.grid.cell_width, r["rows"].shape[1], cfg.num_colliders
    mode = (r["moving"], r["static_desc"], r["chan_free"])
    jobs = (r["jobs"], r["bcells"], r["jbody"], h, cfg.by)
    if nc:
        args = (r["rows"][:24].contiguous(), r["ntiles"], r["btable"], *jobs,
                cfg.group, npad, nc, *mode)
        k, p = p2g_cdf.p2g_cdf_tiles(*args), p2g_cdf.p2g_cdf_plain(*args)
    else:
        args = (r["pdata"], r["ntiles"], r["btable"], *jobs, nc)
        k, p = p2g.p2g_tiles(*args), p2g.p2g_plain(*args)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    args = (r["pdata"], r["ftiles"], r["ntiles"], r["btable"], *jobs, cfg.group, npad,
            nc, *mode)
    ce = int(r["covered_end"])
    assert torch.equal(g2p.g2p_rows(*args)[:, :ce], g2p.g2p_plain(*args)[:, :ce])
    args = (r["rows"], r["krows"], r["pcdf"], r["sorted_ids"], r["covered_end"],
            r["btable"], r["mtable"], d.params.dt, h, nc, max(cfg.n_materials, 1),
            r["live_below"])
    assert torch.equal(update_rows.update_rows(*args), update_rows.update_plain(*args))
    if scene == "ramp":
        sw, vw, prim, cid, grid, _ = chip_smoke.mesh_inputs(d, state)
        args = (sw, vw, prim, cid, grid, r["act"], cfg.amax)
        before = rigid_cdf.mesh_node_cdf_sparse.launches
        k = rigid_cdf.mesh_node_cdf_sparse(*args)
        assert rigid_cdf.mesh_node_cdf_sparse.launches == before + 1
        p = rigid_cdf.mesh_node_cdf_sparse_plain(*args)
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
        assert int((p[0] < rigid_cdf.INF_KEY).sum()) > 10


@pytest.mark.parametrize("scene", ["3d", "2d", "3d_masked", "2d_masked"])
def test_dense_kernels_match_plain(scene):
    """The dense transfer's kernels (dense_pcdf, dense_p2g with its impulses,
    dense_g2p, and C in its centred mode) on a substep of the small sand
    box lowered onto the paddle and of the small sand column lowered into
    its floor, dense, and blocked with a job table too small for them (the
    lane mask drops lanes): bit for bit against their plain versions, and
    the same bits on a second launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from wgsparkl_tpu_torch.collision import cdf
    from wgsparkl_tpu_torch.ops import transfer
    from wgsparkl_tpu_torch.pipeline import step_dense

    kw = (dict(transfer="blocked", group=64, job_chunk=8, max_jobs=8)
          if scene.endswith("masked") else dict(transfer="dense"))
    if scene.startswith("3d"):
        d = scenes.sand_box_3d(nxz=8, ny=16, device="cuda", **kw)
        d.state.particles.pos += torch.tensor([0.0, -3.0, 0.0], device="cuda")
    else:
        d = scenes.sand_column_2d(nx=24, ny=48, cell_width=0.5, device="cuda", **kw)
        d.state.particles.pos += torch.tensor([0.0, -0.75], device="cuda")
    cfg = d.config
    state = step_dense(d.state, d.params, cfg, 2)
    r = {}
    step_dense(state, d.params, cfg, 1, record=r)
    n, nc, grid = state.particles.count, cfg.num_colliders, cfg.grid
    if scene.endswith("masked"):
        assert int(r["live"]) < n
    args = (r["rows"], n, r["node_dist"], r["node_aff"], grid, nc)
    k = cdf.dense_pcdf(*args)
    assert torch.equal(k, cdf.pcdf_rows_plain(*args)) and torch.equal(k, cdf.dense_pcdf(*args))
    assert torch.equal(k, r["pcdf"])
    args = (r["rows"], r["pcdf"], n, r["live"], r["node_aff"], r["node_closest"],
            r["btable"], grid, nc, state.bodies.count)
    k, p, k2 = transfer.dense_p2g(*args), transfer.p2g_plain(*args), transfer.dense_p2g(*args)
    assert float(p[1].abs().max()) > 0.0
    assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(k, p, k2))
    args = (r["rows"], r["pcdf"], n, r["live"], r["grid_vel"], r["node_aff"],
            r["node_closest"], r["btable"], grid, nc)
    k = transfer.dense_g2p(*args)
    assert torch.equal(k, transfer.g2p_plain(*args)) and torch.equal(k, transfer.dense_g2p(*args))
    upd, plain = ((update_rows.update_rows, update_rows.update_plain) if grid.dim == 3
                  else (update_rows.update_rows2d, update_rows.update2d_plain))
    zero = torch.zeros(r["rows"].shape[1], dtype=torch.int32, device="cuda")
    args = (r["rows"], r["krows"], r["pcdf"], zero, n, r["btable"], r["mtable"],
            d.params.dt, grid.cell_width, nc, r["n_mat"], 1, cfg.elastic_model)
    assert torch.equal(upd(*args, centered=True), plain(*args, centered=True))
