"""Frame walls, device time and host-to-device copies of the port's 3D main
path at full size, for the port package of any checkout, on one GPU.

    python3 tools/torch_frame_walls.py ROOT LABEL

ROOT is a checkout (this one, or an unpacked `git archive` of another
commit since the port began) whose wgsparkl_tpu_torch is imported.  Builds
sand_box_3d with the paddle (1,002,001 particles, the sizing of
chip_smoke.py), runs one warm frame of 20 substeps, FRAMES timed frames
(host clock around synchronised frames) and one frame under
torch.profiler, and prints one JSON line: the frame walls, their median,
steps/s, the profiled frame's device time, the idle share against the
median, and the host-to-device copies per substep.  To compare two
commits, run it for both in one call, alternating: parent, change,
change, parent.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

ROOT, LABEL = os.path.abspath(sys.argv[1]), sys.argv[2]
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from wgsparkl_tpu_torch import _cuda, scenes  # noqa: E402
from wgsparkl_tpu_torch.pipeline import step_pallas  # noqa: E402

NXZ, NY, BY, GROUP, SUBSTEPS, FRAMES = 77, 169, 8, 1024, 20, 5


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("FAIL: torch.cuda.is_available() is False")
    here = os.path.dirname(os.path.dirname(os.path.abspath(scenes.__file__)))
    if here != ROOT:
        sys.exit(f"FAIL: imported the port from {here}, not {ROOT}")
    for name in ("p2g_cdf", "g2p", "update_rows", "permute", "compact"):
        _cuda.load(name)
    max_jobs = (NXZ * NXZ * NY // (100 * BY) + 256) // 128 * 128
    d = scenes.sand_box_3d(nxz=NXZ, ny=NY, cell_width=1.0, with_paddle=True,
                           device=torch.device("cuda:0"), by=BY, group=GROUP,
                           max_jobs=max_jobs)
    s = step_pallas(d.state, d.params, d.config, SUBSTEPS)
    torch.cuda.synchronize()
    walls = []
    for _ in range(FRAMES):
        t0 = time.time()
        s = step_pallas(s, d.params, d.config, SUBSTEPS)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.time() - t0))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        s = step_pallas(s, d.params, d.config, SUBSTEPS)
        torch.cuda.synchronize()
    device_ms, htod = 0.0, 0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        dt = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0.0))
        device_ms += dt / 1e3
        if "HtoD" in e.key:
            htod += e.count
    med = statistics.median(walls)
    print(json.dumps({"tree": LABEL, "walls_ms": walls, "median_ms": med,
                      "steps_per_s": SUBSTEPS / med * 1e3, "device_ms": device_ms,
                      "idle": 1 - device_ms / med,
                      "htod_per_substep": htod / SUBSTEPS}), flush=True)


if __name__ == "__main__":
    main()
