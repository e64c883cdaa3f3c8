"""The readings that the limits of limits/<cell>.json are set from, at the
cell's own size, in one process:

    python3 -m mpmbench.calibrate --workload cut2.frame15 --seeds 1,2,3 --control 3

For each seed: the cell's scene built as a run builds it, the frames of
the episode up to its last compared frame run through MpmPipeline.step
(no timed window: the compared frames are the run's, drawn from the same
seed), then the numbers of mpmbench/compare.py for

  program   the program's frames against the float64 reference (the lower
            readings: sound runs);
  control   the reference computed in bfloat16 put in the program's place
            (the first `--control` seeds), substep by substep from the
            float64 reference's own states (run free, the bfloat16
            elastic block blows up within a frame and gives no number);
  unchanged the program's frame returning its state unchanged;
  half      half the particles (odd ids) left as they were before the frame;
  altered   one particle (drawn from the seed) moved by a hundredth of a
            cell after the frame;
  held      (scenes with a kinematic body) every body's state left as it
            was at the frame's start: the kinematic bodies held.

One JSON line a seed; each reading holds every number of compare.py,
body_gap among them.  The runs' own limits take no part here.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from mpmbench import compare, program, run, scene
from mpmbench.reference import Reference


def planted(kind: str, pre: dict, post: dict, h: float, seed: int) -> dict:
    """The program's state after a frame with a fault planted in it."""
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in post.items()}
    if kind == "unchanged":
        return {k: (dict(v) if isinstance(v, dict) else v) for k, v in pre.items()}
    by_pre = torch.empty_like(pre["ids"])
    by_pre[pre["ids"]] = torch.arange(len(pre["ids"]), device=pre["ids"].device)
    back = by_pre[post["ids"]]            # post row -> pre row of the same particle
    if kind == "half":
        keep = (post["ids"] % 2) == 1
        for k in ("pos", "vel", "F", "affine", "phase", "aff"):
            shape = (-1,) + (1,) * (post[k].dim() - 1)
            out[k] = torch.where(keep.view(shape), pre[k][back], post[k])
        out["dps"] = {k: torch.where(keep, pre["dps"][k][back], v)
                      for k, v in post["dps"].items()}
        return out
    if kind == "altered":
        i = int(np.random.default_rng([4, seed]).integers(len(post["ids"])))
        out["pos"] = post["pos"].clone()
        out["pos"][i, 0] += 0.01 * h
        return out
    if kind == "held":
        out["bodies"] = dict(pre["bodies"])
        return out
    raise ValueError(kind)


def readings(workload: str, seed: int, control: bool, device: str = "cuda",
             files=None) -> dict:
    bench = run.load_benchmark()
    cell, config, traffic, limits = files or run.cell_files(bench, workload)
    inputs = scene.make(config, traffic, seed)
    drv = run.Driver(inputs, device)
    cmp_at = run.compared_frames(drv.episode, seed)
    snaps = []
    for n in range(max(cmp_at) + 1):
        pre = program.copy_state(drv.data.state) if n in cmp_at else None
        drv.frame()
        if pre is not None:
            snaps.append((program.read_state(pre), program.read_state(drv.data.state)))
    failed = int(drv.bad)
    initial = program.read_state(drv.initial)
    del drv
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = Reference(inputs, device)
    ref_init = ref.initial()
    every = [ref.frame(pre, every=True) for pre, _ in snaps]
    refs = [e[-1] for e in every]
    h, dt = inputs.h, inputs.dt

    def numbers(init, pairs):
        vals = {"start_gap": compare.start_gap(init, ref_init, h, dt)}
        for post, r in pairs:
            vals = compare.worst(vals, compare.frame_gaps(post, r, h, dt))
        return vals

    out = {"workload": workload, "seed": seed, "frames": cmp_at, "failed": failed,
           "program": numbers(initial, zip([post for _, post in snaps], refs))}
    faults = ("unchanged", "half", "altered")
    if any(c.kinematic for c in inputs.colliders):
        faults += ("held",)
    for kind in faults:
        out[kind] = numbers(initial, zip([planted(kind, pre, post, h, seed)
                                          for pre, post in snaps], refs))
    if control:
        low = Reference(inputs, device, torch.bfloat16)
        f64 = lambda st: {k: (v.double() if torch.is_tensor(v) and v.is_floating_point()  # noqa: E731
                              else ({j: w.double() for j, w in v.items()}
                                    if isinstance(v, dict) else v))
                          for k, v in st.items()}
        cinit = f64(low.initial())
        pairs = [(f64(low.substep(before)), after)
                 for (pre, _), states in zip(snaps, every)
                 for before, after in zip([pre] + states[:-1], states)]
        out["control"] = numbers(cinit, pairs)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3,
                    help="how many of the seeds, first first, also read the control")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mpmbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    for i, s in enumerate(int(x) for x in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, s, i < args.control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
