"""One run of a benchmark cell of wgsparkl_tpu_torch on one card.

    python3 -m mpmbench.run --workload cut2.frame15 --seed 7 --seconds 30 --trace 0

The cell (BENCHMARK.json's `workloads`) names a configuration
(configs/<name>.json through BENCHMARK.json's `configs`) and a traffic mix
(traffic/<name>.json); mpmbench/scene.py makes the run's inputs from them
and the seed.  The run builds the scene through the port's public API,
warms one frame of its shapes and one episode restore, then runs frames for
`--seconds`: a frame is the configuration's substeps in calls of the
traffic's entry (entries/<entry>.py), `substeps_per_call` substeps a call,
ended by torch.cuda.synchronize().  The window replays a fixed episode:
after the traffic's frames the initial state is restored by a device copy,
so every version of the program does the same work.  With `--trace 1` a
few frames after the window run under torch.profiler for the per-layer
metrics.

After the window the port's state is freed and the reference
(mpmbench/reference/) follows the frames drawn from the seed, each from the
program's state before it; mpmbench/compare.py's numbers against
limits/<cell>.json decide `correct`.  The last line of standard output is
the result as JSON; the compared numbers and their limits are the last
lines of standard error too.  The run fails, and prints no result, without
a CUDA card, with fewer cards than the cell asks for, or when JAX or the
JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpmbench import compare, costs, program, scene, trace  # noqa: E402
from mpmbench.reference import Reference  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "wgsparkl_tpu")
COMPARED_FRAMES = 3
PROFILED_FRAMES = 3


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (wgsparkl_tpu_torch is not wgsparkl_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_benchmark(repo=REPO) -> dict:
    return json.loads((pathlib.Path(repo) / "BENCHMARK.json").read_text())


def cell_files(bench: dict, workload: str, repo=REPO):
    """(the cell's entry, its configuration, its traffic, its limits) by the
    names in BENCHMARK.json."""
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((pathlib.Path(repo) / cfg_entry["file"]).read_text())
    traffic = scene.load("traffic", cell["traffic"])
    limits = json.loads((ROOT / "limits" / f"{workload}.json").read_text())
    return cell, config, traffic, limits


def metric_entries(bench: dict, workload: str, traced: bool):
    """The cell's metrics of one kind: end-to-end without the trace,
    per-layer with it (each listing the cell, or listing no cells)."""
    entries = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in entries if workload in m.get("workloads", [workload])]


def read_metric(name: str, ctx: dict):
    """metrics/<name>.py's read(ctx): the value, or None when it finds
    nothing to read."""
    return scene.load_part("metrics", name).read(ctx)


def compared_frames(episode: int, seed: int):
    """The episode's frames the reference follows, drawn from the seed."""
    rng = np.random.default_rng([3, int(seed) & (2 ** 64 - 1)])
    return sorted(int(f) for f in rng.choice(episode, size=min(COMPARED_FRAMES, episode),
                                             replace=False))


class Driver:
    """The cell's scene on the program and the frame loop of the window."""

    def __init__(self, inputs, device):
        self.inputs, self.device = inputs, device
        self.data = program.build(inputs, device)
        self.initial = program.copy_state(self.data.state)
        traffic = inputs.traffic
        self.call = scene.load_part("entries", traffic["entry"]).make(self.data)
        self.per_call = int(traffic["substeps_per_call"])
        if self.per_call < 1 or inputs.substeps % self.per_call:
            raise ValueError(f"substeps_per_call {self.per_call} does not divide the "
                             f"frame's {inputs.substeps} substeps")
        self.episode = traffic["episode_frames"]
        self.pos_in_episode = 0
        self.bad = torch.zeros((), dtype=torch.int32, device=device)

    def sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def restore(self):
        self.data.state = program.copy_state(self.initial)
        self.pos_in_episode = 0

    def frame(self):
        """One frame: (wall s, host s in the entry); the episode restarts
        first when it is over.  Counts the frame as failed on a StepDiag
        fault or a non-finite position (on the device, read at the end)."""
        if self.pos_in_episode == self.episode:
            self.restore()
        t0 = time.perf_counter()
        diags = [self.call(self.per_call)
                 for _ in range(self.inputs.substeps // self.per_call)]
        t1 = time.perf_counter()
        self.sync()
        t2 = time.perf_counter()
        bad = ~torch.isfinite(self.data.state.particles.pos).all()
        for diag in diags:
            if diag is not None:
                bad = bad | (sum(getattr(diag, k).max() for k in diag.FAULTS) > 0)
        self.bad += bad.to(torch.int32)
        self.pos_in_episode += 1
        return t2 - t0, t1 - t0


def run_cell(bench: dict, workload: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", repo=REPO, log=sys.stderr, files=None) -> dict:
    """One run of the cell: the result dict (the last line's JSON).  files:
    (cell, configuration, traffic, limits) in place of the cell's files (a
    test's smaller scene)."""
    cell, config, traffic, limits = files or cell_files(bench, workload, repo)
    cuda = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = scene.make(config, traffic, seed)
    drv = Driver(inputs, device)
    S = inputs.substeps
    # Warm every shape the window uses: a frame, the restore, the copies.
    drv.frame()
    drv.restore()
    program.copy_state(drv.data.state)
    drv.sync()
    drv.bad.zero_()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cmp_at = compared_frames(drv.episode, seed)
    snaps = {}
    frame_s, host_s = [], []
    setup_s = time.perf_counter() - T0
    start = time.perf_counter()
    n, untimed = 0, 0.0
    # The compared frames' states are copied to the host around them, the
    # device idle; the copies' time is taken out of the window.
    while time.perf_counter() - start - untimed < seconds:
        t = time.perf_counter()
        pre = program.copy_state(drv.data.state, "cpu") if n in cmp_at else None
        untimed += time.perf_counter() - t
        w, hs = drv.frame()
        frame_s.append(w)
        host_s.append(hs)
        if pre is not None:
            t = time.perf_counter()
            snaps[n] = (pre, program.copy_state(drv.data.state, "cpu"))
            untimed += time.perf_counter() - t
        n += 1
    wall = time.perf_counter() - start - untimed
    # Compared frames the window did not reach are run now, untimed.
    while len(snaps) < len(cmp_at):
        pre = program.copy_state(drv.data.state, "cpu") if n in cmp_at else None
        drv.frame()
        if pre is not None:
            snaps[n] = (pre, program.copy_state(drv.data.state, "cpu"))
        n += 1
    failed = int(drv.bad)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = {"substeps": S, "setup_s": setup_s, "trace": None,
           "window": {"frames": len(frame_s), "frame_s": frame_s, "host_s": host_s,
                      "wall_s": wall}}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced:
        breakdown = _trace(drv, ctx, dev_info, repo, log)
    refuse_forbidden()
    metrics = {}
    for m in metric_entries(bench, workload, traced):
        v = read_metric(m["name"], ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    # The program's state goes; the reference follows the compared frames.
    initial = program.read_state(drv.initial)
    snaps = {f: (program.read_state(a, device), program.read_state(b, device))
             for f, (a, b) in snaps.items()}
    del drv, ctx
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    values = check(inputs, initial, [snaps[f] for f in cmp_at], device)
    print(f"frames {len(frame_s)} in {wall:.3f} s; compared frames {cmp_at}, the reference "
          f"took {time.perf_counter() - t_ref:.3f} s", file=log, flush=True)
    correct = compare.judge(values, limits) and failed == 0
    lines = [f"{k} {values[k]:.6e} limit {limits[k]:.6e}" for k in limits]
    lines.append(f"failed_frames {failed} limit 0")
    print("\n".join(lines), file=log, flush=True)
    result = {"correct": bool(correct), "attempted": len(frame_s), "failed": failed,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {**{k: {"value": values[k], "limit": limits[k]} for k in limits},
                        "failed_frames": {"value": failed, "limit": 0}}
    return result


def check(inputs, initial: dict, snaps, device, dtype=torch.float64) -> dict:
    """The compared numbers: the start against the reference's own initial
    state, then each compared frame from the program's state before it
    (the largest gap over the frames)."""
    ref = Reference(inputs, device, dtype)
    values = {"start_gap": compare.start_gap(initial, ref.initial(), inputs.h, inputs.dt)}
    for pre, post in snaps:
        values = compare.worst(values, compare.frame_gaps(post, ref.frame(pre), inputs.h,
                                                          inputs.dt))
    return values


def _trace(drv: Driver, ctx: dict, dev_info: dict, repo, log) -> dict:
    """Profile PROFILED_FRAMES frames after the window with the device's
    activity alone (the per-layer metrics, busy_s, window_s), follow them
    again substep by substep for the kernels' counts, then profile as many
    more with the host's activity too (the idle gaps by what the host did:
    the host ops' records slow the host, so that pass gives the breakdown
    alone).  Neither pass crosses an episode's end: the episode restarts
    first where it would.  Fills ctx and dev_info, returns the breakdown."""
    S = drv.inputs.substeps

    def start_clear():
        if drv.pos_in_episode + PROFILED_FRAMES > drv.episode:
            drv.restore()
        drv.sync()

    start_clear()
    pre = program.copy_state(drv.data.state)
    tr = trace.profile(drv.frame, PROFILED_FRAMES, tempfile.gettempdir(), host=False)
    names = trace.kernel_names(pathlib.Path(repo) / "wgsparkl_tpu_torch" / "csrc")
    by_stem, glue = {}, 0.0
    for name, cat, _, d in tr.device:
        stem = trace.source_of(name, names) if cat == "kernel" else None
        if stem is None:
            glue += d
        else:
            by_stem[stem] = by_stem.get(stem, 0.0) + d
    # The same substeps again, one recorded substep at a time.
    bound_ms = {}
    state = pre
    for _ in range(PROFILED_FRAMES * S):
        state, counts = program.substep_counts(drv.data, state)
        for stem, ms in costs.substep_bounds(counts).items():
            bound_ms[stem] = bound_ms.get(stem, 0.0) + ms
    del state, pre
    for stem in sorted(set(by_stem) | set(bound_ms)):
        dev_ms = by_stem.get(stem, 0.0) * 1e-3
        b = bound_ms.get(stem)
        share = f"{100 * b / dev_ms:.4f}%" if b and dev_ms else "none"
        print(f"roofline {stem}: bound {b} ms, device {dev_ms} ms, share {share}",
              file=log, flush=True)
    ctx.update(trace=tr, profiled_substeps=PROFILED_FRAMES * S, bound_ms=bound_ms,
               device_us={"kernels": sum(by_stem.values()), "glue": glue})
    dev_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
    start_clear()
    host_tr = trace.profile(drv.frame, PROFILED_FRAMES, tempfile.gettempdir(), host=True)
    print(f"profiled frames: device pass busy {tr.busy_s():.6f} s of {tr.window_s:.6f} s; "
          f"host pass busy {host_tr.busy_s():.6f} s of {host_tr.window_s:.6f} s",
          file=log, flush=True)
    return trace.breakdown(tr, host_tr)


def refuse_forbidden():
    """Ends the run, with no result, where JAX or the JAX package is loaded
    in this process."""
    bad = forbidden_modules()
    if bad:
        print(f"mpmbench: loaded {', '.join(bad)} (JAX or the JAX package) in the "
              "measured process; no result", file=sys.stderr, flush=True)
        raise SystemExit(3)


def emit(result: dict, out=None):
    """Prints the result as the last line of standard output, once nothing
    forbidden has been loaded (the metrics' readers and the reference have
    run by now)."""
    refuse_forbidden()
    print(json.dumps(result), file=out or sys.stdout, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_benchmark()
    chips = next(w for w in bench["workloads"] if w["name"] == args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"mpmbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    emit(run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
