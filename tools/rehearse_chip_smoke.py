"""CPU rehearsal of chip_smoke.py, for a host without a CUDA device.

    python3 tools/rehearse_chip_smoke.py            # every phase, ~2 min
    REHEARSE_ONLY=mesh python3 tools/rehearse_chip_smoke.py   # paths 9-11
    REHEARSE_ONLY=dense python3 tools/rehearse_chip_smoke.py  # paths 13-14
    REHEARSE_ONLY=substep python3 tools/rehearse_chip_smoke.py  # path 17
    REHEARSE_ONLY=parallel python3 tools/rehearse_chip_smoke.py  # paths 15-15d

Paths 15-15d and phase 6's multi-device scenes run their ranks as spawned
CPU processes on gloo; a spawned rank imports this script again (as
__mp_main__), which gives it the same stubs, counters and sizes, and only
the run below stays in the parent.

Stubs torch.cuda, nvidia-smi and the nvcc build, counts launches where the
pipeline calls each kernel wrapper (a wrapper counts only its CUDA
launches), shrinks the scenes and runs every phase with the plain
versions on the CPU.  It finds wrong paths, arguments, shapes and control
flow; it measures nothing."""
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch

torch.set_num_threads(4)


class _Event:
    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 1.0


torch.cuda.is_available = lambda: True
torch.cuda.synchronize = lambda *a, **k: None
torch.cuda.Event = _Event
torch.cuda.get_device_name = lambda *a: "CPU rehearsal"
torch.cuda.empty_cache = lambda: None
torch.cuda.device_count = lambda: 1
torch.cuda.set_sync_debug_mode = lambda *a: None

import subprocess  # noqa: E402

_real_run = subprocess.run


def _run(cmd, *a, **k):
    if cmd and cmd[0] == "nvidia-smi":
        return types.SimpleNamespace(stdout="CPU rehearsal, 0 W\n", returncode=0)
    return _real_run(cmd, *a, **k)


subprocess.run = _run

import chip_smoke as cs  # noqa: E402
from wgsparkl_tpu_torch import _cuda, pipeline  # noqa: E402
from wgsparkl_tpu_torch.collision import cdf  # noqa: E402
from wgsparkl_tpu_torch.math import probe  # noqa: E402
from wgsparkl_tpu_torch.ops import ablation, compact, rigid_cdf, transfer  # noqa: E402
from wgsparkl_tpu_torch.ops import blocked as bk  # noqa: E402
from wgsparkl_tpu_torch.ops import update_rows as upd  # noqa: E402

_cuda.build = lambda names: None
_cuda.load = lambda name: None
cs.ptxas_reports = lambda _c, kernels: (lambda: {})


def counted(mod, name):
    f = getattr(mod, name)

    def w(*a, **k):
        f.launches += 1
        w.launches += 1
        return f(*a, **k)

    w.launches = 0
    setattr(mod, name, w)


for n in ("p2g_cdf_tiles", "g2p_rows", "permute_lanes", "pcdf_rows2d",
          "p2g_tiles2d", "g2p_rows2d", "update_rows2d", "p2g_tiles", "rigid_solve"):
    counted(pipeline, n)
# Kernels the struct forms (ops/transfer.p2g, g2p, particle_update,
# utils/timing) call from their own modules: one wrapper each, which the
# pipeline calls too.
for m, n in ((cdf, "dense_pcdf"), (transfer, "dense_p2g"), (transfer, "dense_g2p"),
             (upd, "update_rows")):
    counted(m, n)
    setattr(pipeline, n, getattr(m, n))
counted(compact, "compact_flagged")
# The CPU's window scatter stays add_rows; count a scatter_pull launch
# where the card's bounded grid would run one (not under plain_versions).
_scatter = pipeline._scatter


def _scatter_counted(mm, ph, cfg):
    if not cfg.sparse and hasattr(bk.scatter_tiles_pull, "launches"):
        bk.scatter_tiles_pull.launches += 1
    return _scatter(mm, ph, cfg)


pipeline._scatter = _scatter_counted
counted(rigid_cdf, "mesh_node_cdf")
counted(rigid_cdf, "mesh_node_cdf_sparse")
counted(probe, "math_probe")
# The ablation probe's partial stages exist only as kernels.
_full = ablation.p2g_ablation
ablation.p2g_ablation = lambda *a, stage="full", core="lists", **k: _full(
    *a, stage="full", core=core, **k)
ablation.p2g_ablation.launches = 0
_inputs = ablation.probe_inputs
ablation.probe_inputs = lambda n=20000, *a, device=None, **k: _inputs(
    n, 256, 64, 40, device=device)

cs.DEVICE = "cpu"
cs.NXZ, cs.NY = 12, 24
cs.NX2, cs.NY2, cs.H2, cs.GROUP2 = 256, 64, 0.5, 128
cs.STIR_SCALE = cs.NX2 * cs.H2 / 12
cs.N_SAND2 = 64
cs.N_CUT2, cs.CUT3_SCALE, cs.HF3_SCALE = 48, 0.2, 0.2
cs.SUBSTEPS, cs.SUBSTEPS2, cs.SUBSTEPS_NEO2, cs.SUBSTEPS_CUT2 = 4, 4, 4, 4
cs.TIMED_FRAMES = 1
cs.TIMED_FRAMES_SHORT = 1
only = os.environ.get("REHEARSE_ONLY")
if __name__ == "__main__":
    import wgsparkl_tpu_torch as wt
    if only == "mesh":
        cs.mesh_paths(wt, "CPU rehearsal", "CPU rehearsal", {}, 1)
    elif only == "dense":
        cs.dense_paths(wt, "CPU rehearsal", "CPU rehearsal", {}, 1)
    elif only == "substep":
        cs.substep_paths(wt, "CPU rehearsal", "CPU rehearsal", {})
    elif only == "parallel":
        cs.parallel_paths(wt, "CPU rehearsal", "CPU rehearsal", {}, {})
        cs.parallel_small_scenes("cpu")
    else:
        cs.main()
