"""The P2G ablation probe (port of tools/ablate_kernels.py; csrc/
p2g_ablation.cu): one P2G pass cut into stages, timed on synthetic jobs at
the main path's size, with three node-side cores.

Stages (each includes the ones before): "load" (the job's 16 P2G rows into
shared memory), "weights" (+ stencil weights and the particle records),
"accumulate" (+ the 13 node sums) and "full" (+ the recombination with the
node position: kernel A's P2G, the TPU probe's "full"; its "full2" computes
the same function with another layout of the MXU product).  Cores: "scan",
the node loop kernels A and F ran before their redesign (every window node
tests every particle of a 256-particle chunk); "lists", kernel A's
per-node particle lists (csrc/transfer.cuh, one thread per node); and
"pairs", the same lists walked by one thread per two z-neighbour nodes
(list_walk_pair), in the lists order.  Only "full" has a plain version; it
sums each node in the order of the core asked for.
"""

from __future__ import annotations

import numpy as np
import torch

from wgsparkl_tpu_torch import _cuda
from wgsparkl_tpu_torch.device import resolve
from wgsparkl_tpu_torch.ops import rows as R
from wgsparkl_tpu_torch.ops.p2g_cdf import p2g_node_tiles

# The TPU probe's sizes (tools/ablate_kernels.py:13-18): particles, group,
# block height, job slots, live jobs; grid (108, 112, 108) at h = 1 with
# origin cell (-2, -2, -2), of which the P2G reads only h.
N, G, BY, MAXJ, NLIVE = 1_002_001, 1024, 8, 1536, 1300
CELL_WIDTH = 1.0
REPS = 10  # timed launches of each stage, after a warm one
STAGES = ("load", "weights", "accumulate", "full")
CORES = ("scan", "lists", "pairs")


def probe_inputs(n: int = N, group: int = G, maxj: int = MAXJ, nlive: int = NLIVE,
                 device=None):
    """The TPU probe's synthetic jobs, built by its numpy calls in its order
    (numpy default_rng(0)): nlive live jobs of n // nlive particles in
    random 4 x 8 x 4 blocks, positions inside the block, velocities
    N(0, 0.1), mass 1, affine rows 0.  Returns (pdata [24, NPAD + group +
    128] f32, start [maxj] int32, len [maxj] int32, bcells [maxj, 3]
    int32) on `device` (None: the card)."""
    device = resolve(device)
    npad = -(-n // 256) * 256
    rng = np.random.default_rng(0)
    starts = np.zeros(maxj, np.int32)
    lens = np.zeros(maxj, np.int32)
    per = n // nlive
    pos = np.zeros((n, 3), np.float32)
    bcells = np.zeros((maxj, 3), np.int32)
    r = 0
    for j in range(nlive):
        starts[j] = r
        ln = min(per, n - r)
        lens[j] = ln
        bx, by_, bz = rng.integers(0, 25, 3)
        bcells[j] = (bx * 4 - 2, by_ * 8 - 2, bz * 4 - 2)
        pos[r:r + ln] = ((bcells[j] + 1.0)
                         + rng.random((ln, 3)) * np.array([3.0, 7.0, 3.0]))
        r += ln
    pdata = np.zeros((R.NCHAN, npad + group + 128), np.float32)
    pdata[0:3, :n] = pos.T
    pdata[3:6, :n] = rng.normal(size=(3, n)) * 0.1
    pdata[6, :n] = 1.0
    return tuple(torch.as_tensor(a, device=device)
                 for a in (pdata, starts, lens, bcells))


def p2g_ablation_plain(pdata, starts, lens, bcells, core: str = "lists"):
    """The full stage: [MAXJ, wpad, 8] tiles, each node's pairs summed in
    the core's order (scan: particle order; lists and pairs:
    rows.lists_order)."""
    if core not in CORES:
        raise ValueError(f"core {core!r} is not one of {CORES}")
    wsh, wvol, wpad = R.window_geom(BY)
    jid, lane = R.job_lanes({"start": starts, "len": lens})
    pd = pdata[:16, lane]
    bc = bcells.to(torch.int64)[jid]
    w, nidx, _ = R.stencil([pd[R.PX], pd[R.PY], pd[R.PZ]], bc, R.f32(1.0 / CELL_WIDTH),
                           wsh)
    order = None if core == "scan" else R.lists_order(jid, lens)
    return p2g_node_tiles(pd, w, jid[:, None] * wvol + nidx,
                          R.window_positions(bcells, CELL_WIDTH, wsh), wpad, order)


def p2g_ablation(pdata, starts, lens, bcells, stage: str = "full", core: str = "lists",
                 group: int = G):
    """[MAXJ, wpad, 8] f32: the stage's tiles from the CUDA kernel for CUDA
    tensors; on the CPU the full stage's plain version (the earlier stages
    exist only as kernels).  pdata [>=16, L] f32 rows, starts / lens [MAXJ]
    int32 (each job's lanes in pdata, len <= group), bcells [MAXJ, 3] int32
    block origin cells."""
    if stage not in STAGES or core not in CORES:
        raise ValueError(f"stage {stage!r} / core {core!r}: one of {STAGES} / "
                         f"{CORES}")
    if pdata.device.type == "cpu":
        if stage != "full":
            raise ValueError(f"the {stage!r} stage runs only as a CUDA kernel")
        return p2g_ablation_plain(pdata, starts, lens, bcells, core)
    _, wvol, wpad = R.window_geom(BY)
    maxj = starts.shape[0]
    if (pdata.dtype != torch.float32 or pdata.shape[0] < 16
            or bcells.shape != (maxj, 3)
            or any(t.dtype != torch.int32 for t in (starts, lens, bcells))):
        raise ValueError("p2g_ablation: f32 rows, int32 [MAXJ] starts and "
                         "lens and [MAXJ, 3] bcells")
    R.check_kernel_args(pdata, starts, lens, bcells)
    out = torch.empty((maxj, wpad, 8), dtype=torch.float32, device=pdata.device)
    _cuda.launch("p2g_ablation", "p2g_ablation_cuda", "pipppiiffiiip",
                 pdata, pdata.shape[1], starts, lens, bcells, maxj, BY,
                 R.f32(CELL_WIDTH), R.f32(1.0 / CELL_WIDTH), CORES.index(core),
                 STAGES.index(stage), min(group, R.LIST_CHUNK), out)
    p2g_ablation.launches += 1
    return out


p2g_ablation.launches = 0


def stage_table(inputs):
    """Every stage of every core on the card, on inputs = probe_inputs():
    (lines to print, {(core, stage): ms per launch}), each time from CUDA
    events around REPS launches after a warm one.  Raises if a core's
    full stage differs from its plain version in any bit."""
    pdata, starts, lens, bcells = inputs
    ms, lines = {}, []
    for core in CORES:
        full = p2g_ablation(*inputs, stage="full", core=core)
        plain = p2g_ablation_plain(*inputs, core=core)
        if not torch.equal(full, plain):
            err = float((full.double() - plain.double()).abs().max())
            raise RuntimeError(f"p2g_ablation {core}: the full stage differs from "
                               f"its plain version (max abs err {err:.3e})")
        for stage in STAGES:
            p2g_ablation(*inputs, stage=stage, core=core)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(REPS):
                p2g_ablation(*inputs, stage=stage, core=core)
            t1.record()
            torch.cuda.synchronize()
            ms[core, stage] = t0.elapsed_time(t1) / REPS
    n, live = int(lens.sum()), int((lens > 0).sum())
    lines.append(f"{n} particles in {live} live jobs of {starts.shape[0]}; "
                 "ms per launch, each stage including the ones above it")
    lines.append(f"{'stage':12s}" + "".join(f"{c:>10s}" for c in CORES))
    for stage in STAGES:
        lines.append(f"{stage:12s}" + "".join(f"{ms[c, stage]:10.4f}" for c in CORES))
    lines.append("full: each core equals its plain version bit for bit")
    return lines, ms
