"""Build-ahead warmup (port of wgsparkl_tpu/utils/warmup.py).

    python -m wgsparkl_tpu_torch.utils.warmup --particles 1000000 \\
        --substeps 20 --group 512 [--sparse] [--cpu]

The port compiles nothing per shape: its CUDA kernels are built once per
source (nvcc into wgsparkl_tpu_torch/_build/, `_cuda.build`) and loaded on
first use.  `warmup` builds them all, then runs one frame of the 3D sand box
with the paddle sized to about `n_particles` (the JAX tool's scene and job
table), so that the first frame a user times finds every kernel built,
loaded and launched once.  It returns the seconds both took; `__main__`
prints them as one JSON record and writes no file.
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def warmup(n_particles: int, substeps: int, group: int, sparse: bool = False,
           device=None) -> float:
    """Seconds to build the kernels (on the card) and run one frame of
    `substeps` substeps at that size; prints the JSON record."""
    from wgsparkl_tpu_torch import _cuda, scenes
    from wgsparkl_tpu_torch.device import resolve
    from wgsparkl_tpu_torch.pipeline import step_with_diag

    dev = resolve(device)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        _cuda.build(_cuda.sources())
    build_s = time.perf_counter() - t0
    nxz = int(round((n_particles / 2.2) ** (1.0 / 3.0)))
    ny = int(round(n_particles / (nxz * nxz)))
    n = nxz * nxz * ny
    max_jobs = int((-(-n // group) * 1.5 + 256) // 128 * 128)
    data = scenes.sand_box_3d(nxz=nxz, ny=ny, cell_width=1.0, with_paddle=True,
                              num_substeps=substeps, device=dev, transfer="pallas",
                              group=group, max_jobs=max_jobs, sparse=sparse)
    t1 = time.perf_counter()
    state, diag = step_with_diag(data.state, data.params, data.config, substeps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    frame_s = time.perf_counter() - t1
    rec = {"kind": "warmup", "particles": n, "substeps": substeps, "group": group,
           "sparse": sparse, "build_s": build_s, "frame_s": frame_s,
           "diag": diag.summary(), "finite": bool(torch.isfinite(state.particles.pos).all()),
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")}
    print(json.dumps(rec))
    return build_s + frame_s


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--particles", type=int, default=1_000_000)
    ap.add_argument("--substeps", type=int, default=20)
    ap.add_argument("--group", type=int, default=512)
    ap.add_argument("--sparse", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain versions) instead of the card")
    args = ap.parse_args(argv)
    warmup(args.particles, args.substeps, args.group, args.sparse,
           device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
