"""Where a frame's time goes in the PyTorch/CUDA port, on one GPU.

    python3 tools/torch_profile.py PATH

PATH is one of 3d, 3d-fold, 3d-neo, 3d-free, 3d-shapes, 3d-shapes-chan-free,
3d-dyn, 2d, 2d-fold, 2d-neo, 2d-stirred, 2d-stirred-chan-free, sand2, cut2,
cut3, hf3, sparse, hf3-sparse, dense, dense-2d, blocked, sharded, spatial.
Builds the
full-size scene of chip_smoke.py (3d: the 1,002,001-particle sand box with
the paddle, 20 substeps a frame; 3d-fold: the same with the grid update
folded into G2P (`fold_vel`); 3d-neo: the same with the neo-Hookean
stress; 3d-free: the same lattice, models and grid with no body, spinning;
3d-shapes: the same lattice, models and grid with path 5's analytic
colliders (halfspace, walls, capsule, ball) in the gathered-hybrid CDF
mode; 3d-shapes-chan-free: the same in the chan-free mode; 2d: the
490,000-particle sand column, 10 substeps a frame; 2d-fold: the same
folded; 2d-neo: the 490,000-particle neo-Hookean elastic blocks, 15
substeps a frame; 2d-stirred: path 6, the sand column stirred by a
kinematic ball and capsule, in the dense CDF mode; 2d-stirred-chan-free:
the same chan-free; 3d-dyn: path 8, the 3D main path with two dynamic
plates on the sand; sand2: path 7, examples/sand2.py at SCALE=1 with its
two dynamic plates, 10 substeps a frame; cut2: path 9, examples/
elastic_cut2.py at SCALE=1, 15 substeps a frame; cut3: path 10,
examples/elastic_cut3.py at SCALE=1; hf3: path 11, examples/heightfield3.py
at SCALE=1; sparse: path 12, the 3d lattice in the sparse domain as
bench.py's BENCH_SPARSE=1 run builds it; hf3-sparse: path 12b, path
11 built sparse; dense: path 13, the 3d lattice on the dense transfer;
dense-2d: path 13b, the 2d column on the dense transfer; blocked: path 14,
the 3d lattice on the blocked transfer; sharded: path 15, the 3d lattice
particle-sharded over 4 ranks; spatial: path 15b, the 3d lattice in 4 x
slabs on its widened grid), runs one warm frame and chip_smoke.TIMED_FRAMES (3)
unprofiled frames (host clock around synchronised frames), then one frame
under torch.profiler.  Prints the frame wall times, the device time of the
profiled frame, the device's idle share against the median unprofiled
frame, the device launches (kernels, copies, fills) a substep, the
kernels by device time per substep: the 40 largest and every hand-written
one, on a 2D path kernel G's device ms a substep and a launch, on
paths 7 and 8 the rigid solve's, and on paths 9-11 the mesh pass's
(mesh_cdf3_kernel / mesh_cdf2_kernel) and the fracture branch's lanes,
on the sparse paths the slot channel grid's ms a call (CUDA events around
`pipeline._sparse_chan_grid` on a substep's active table) and its share
of a substep's device time, on the dense and blocked paths each dense
kernel's device ms and launches a substep.  The sharded and spatial paths
run their 4 ranks on the one card through gloo (buffers staged through
pinned host memory: a correctness set-up, not a multi-device speed), every
rank stepping the frames, and profile rank 0 (sharded) or the middle rank
1 (spatial); they also print the device and host ms a substep of the
spans "mpm.exchange" (the grid's sum or halo exchange and the
impulses' sums, staging included) and "mpm.migrate_x" (the migration and
the second sort) and their shares of the rank's device time and frame wall.
Fails without a CUDA device, on a 2D path where G did not launch, on
paths 7 and 8 where the rigid solve did not and on paths 9-11 where the
mesh pass did not.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke  # noqa: E402
from wgsparkl_tpu_torch.utils import tracing  # noqa: E402


ACTS = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


# Spans of the multi-device step (pipeline, utils/tracing.py).
SPANS = ("mpm.exchange", "mpm.migrate_x")


def device_rows(prof):
    """(device ms, calls, name) of each device-side event (kernels, copies,
    fills), largest first: the CPU operators that launched them carry the
    same device time again, and a span's device-side row (its extent on the
    device's timeline, idle gaps included; names from tracing.PREFIX) is
    left out."""
    rows = []
    for e in prof.key_averages():
        if (getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA
                or e.key.startswith(tracing.PREFIX)):
            continue
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        if dt > 0:
            rows.append((dt / 1e3, e.count, e.key))
    if not rows:
        sys.exit("FAIL: the profiler recorded no device events")
    return sorted(rows, reverse=True)


def report(rows, walls, substeps) -> float:
    """Print the frame walls, the profiled frame's device time, idle share
    and launches, and the kernels by device time; returns the device ms."""
    device_ms = sum(r[0] for r in rows)
    median = statistics.median(walls)
    print("unprofiled frame wall ms: " + ", ".join(f"{w:.3f}" for w in walls))
    print(f"profiled frame: device time {device_ms:.3f} ms "
          f"({device_ms / substeps:.3f} ms a substep); idle share against the "
          f"median unprofiled frame {1.0 - device_ms / median:.3f}; "
          f"{sum(r[1] for r in rows) / substeps:.1f} device launches a substep")
    print("device ms a substep, calls a substep, kernel:")
    # The 40 largest, then the port's own kernels among the rest (their
    # names carry no namespace, unlike PyTorch's and CUB's).
    own = [r for r in rows[40:] if "::" not in r[2] and not r[2].startswith("Mem")]
    for ms, count, key in rows[:40] + own:
        print(f"  {ms / substeps:8.4f}  {count / substeps:6.1f}  {key[:110]}")
    return device_ms


def profile_rank(comm, state, params, cfg, profiled: int):
    """Rank hook: a warm frame and chip_smoke.TIMED_FRAMES timed frames on
    every rank, then one frame under torch.profiler on rank `profiled`;
    returns that rank's frame walls, device rows and spans (name, device
    ms of the kernels launched inside, host ms, device-timeline extent ms,
    calls), None on the others."""
    from wgsparkl_tpu_torch.pipeline import step_pallas

    substeps = chip_smoke.SUBSTEPS
    state = step_pallas(state, params, cfg, substeps, comm=comm)
    torch.cuda.synchronize()
    walls = []
    for _ in range(chip_smoke.TIMED_FRAMES):
        t0 = time.time()
        state = step_pallas(state, params, cfg, substeps, comm=comm)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.time() - t0))
    me = comm.rank == profiled
    with (torch.profiler.profile(activities=ACTS, acc_events=True) if me
          else contextlib.nullcontext()) as prof:
        state = step_pallas(state, params, cfg, substeps, comm=comm)
        torch.cuda.synchronize()
    if not me:
        return None
    host, extent = {}, {}
    for e in prof.key_averages():
        if e.key in SPANS:
            on_device = getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            if on_device:
                extent[e.key] = getattr(e, "device_time_total", 0.0) / 1e3
            else:
                host[e.key] = (getattr(e, "device_time_total", 0.0) / 1e3,
                               e.cpu_time_total / 1e3, e.count)
    spans = [(k, *host[k][:2], extent.get(k, 0.0), host[k][2]) for k in host]
    return walls, device_rows(prof), spans


def profile_ranks(path: str, card: str) -> None:
    """Path 15 (sharded) or 15b (spatial) on 4 ranks sharing the card: the
    profile of one rank (rank 0, or the middle rank 1 in slabs)."""
    from wgsparkl_tpu_torch.parallel import spatial_config

    world, substeps = chip_smoke.WORLD_15, chip_smoke.SUBSTEPS
    data = chip_smoke.full_scene(torch.device(chip_smoke.DEVICE))
    cfg, profiled = data.config, 0
    if path == "spatial":
        chip_smoke.widened(data, world)
        cfg = spatial_config(data.config, world, chip_smoke.MIGRATION_CAP)
        profiled = chip_smoke.record_rank(world)
    res = chip_smoke.run_ranks(data, cfg, world, [], f"{path} path",
                               after=functools.partial(profile_rank, profiled=profiled),
                               pad=path == "sharded")
    walls, rows, spans = res[profiled]["after"]
    print(f"{path} path, {data.num_particles} particles over {world} ranks sharing "
          f"one card (gloo, host-staged: a correctness set-up), rank {profiled} "
          f"profiled, {substeps} substeps a frame, on {torch.cuda.get_device_name(0)} "
          f"({card})")
    device_ms = report(rows, walls, substeps)
    median = statistics.median(walls)
    for name, dms, hms, ext, count in spans:
        print(f"span {name}: its kernels and copies {dms / substeps:.4f} ms a substep "
              f"({dms / device_ms:.3f} of the rank's device time), host "
              f"{hms / substeps:.4f} ms a substep ({hms / median:.3f} of the median "
              f"frame wall), extent on the device's timeline {ext / substeps:.4f} ms "
              f"a substep, {count / substeps:.1f} calls a substep")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", choices=("3d", "3d-fold", "3d-neo", "3d-free",
                                     "3d-shapes", "3d-shapes-chan-free", "2d",
                                     "2d-fold", "2d-neo", "2d-stirred",
                                     "2d-stirred-chan-free", "3d-dyn", "sand2",
                                     "cut2", "cut3", "hf3", "sparse",
                                     "hf3-sparse", "dense", "dense-2d", "blocked",
                                     "sharded", "spatial"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("FAIL: torch.cuda.is_available() is False")
    from wgsparkl_tpu_torch import _cuda
    from wgsparkl_tpu_torch.pipeline import step, step_pallas

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    _cuda.build(_cuda.sources())
    dev = torch.device("cuda:0")
    if args.path in ("sharded", "spatial"):
        profile_ranks(args.path, card)
        return
    data, substeps = {
        "3d": lambda: (chip_smoke.full_scene(dev), chip_smoke.SUBSTEPS),
        "3d-fold": lambda: (chip_smoke.full_scene(dev, fold_vel=True),
                            chip_smoke.SUBSTEPS),
        "3d-neo": lambda: (chip_smoke.full_scene(dev, elastic_model="neo_hookean"),
                           chip_smoke.SUBSTEPS),
        "3d-free": lambda: (chip_smoke.full_scene_free(dev), chip_smoke.SUBSTEPS),
        "3d-shapes": lambda: (chip_smoke.full_scene_shapes(dev, False),
                              chip_smoke.SUBSTEPS),
        "3d-shapes-chan-free": lambda: (chip_smoke.full_scene_shapes(dev, True),
                                        chip_smoke.SUBSTEPS),
        "2d": lambda: (chip_smoke.full_scene_2d(dev), chip_smoke.SUBSTEPS2),
        "2d-fold": lambda: (chip_smoke.full_scene_2d(dev, fold_vel=True),
                            chip_smoke.SUBSTEPS2),
        "2d-stirred": lambda: (chip_smoke.full_scene_stirred_2d(dev),
                               chip_smoke.SUBSTEPS2),
        "2d-stirred-chan-free": lambda: (chip_smoke.full_scene_stirred_2d(dev, True),
                                         chip_smoke.SUBSTEPS2),
        "2d-neo": lambda: (chip_smoke.full_scene_neo_2d(dev),
                           chip_smoke.SUBSTEPS_NEO2),
        "3d-dyn": lambda: (chip_smoke.full_scene_plates(dev), chip_smoke.SUBSTEPS),
        "sand2": lambda: (chip_smoke.sand2_scene(dev, group=chip_smoke.GROUP2),
                          chip_smoke.SUBSTEPS2),
        "cut2": lambda: (chip_smoke.cut2_scene(dev), chip_smoke.SUBSTEPS_CUT2),
        "cut3": lambda: (chip_smoke.cut3_scene(dev), chip_smoke.SUBSTEPS),
        "hf3": lambda: (chip_smoke.hf3_scene(dev), chip_smoke.SUBSTEPS),
        "sparse": lambda: (chip_smoke.full_scene_sparse(dev), chip_smoke.SUBSTEPS),
        "hf3-sparse": lambda: (chip_smoke.hf3_scene(dev, sparse=True),
                               chip_smoke.SUBSTEPS),
        "dense": lambda: (chip_smoke.dense_scene(dev, transfer="dense"),
                          chip_smoke.SUBSTEPS),
        "dense-2d": lambda: (chip_smoke.dense_scene_2d(dev), chip_smoke.SUBSTEPS2),
        "blocked": lambda: (chip_smoke.dense_scene(dev, transfer="blocked"),
                            chip_smoke.SUBSTEPS),
    }[args.path]()
    state, params, cfg = data.state, data.params, data.config
    state = step(state, params, cfg, substeps)
    torch.cuda.synchronize()
    walls = []
    for _ in range(chip_smoke.TIMED_FRAMES):
        t0 = time.time()
        state = step(state, params, cfg, substeps)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.time() - t0))
    with torch.profiler.profile(activities=ACTS, acc_events=True) as prof:
        state = step(state, params, cfg, substeps)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    print(f"{args.path} path, {data.num_particles} particles, {substeps} substeps "
          f"a frame, on {torch.cuda.get_device_name(0)} ({card})")
    device_ms = report(rows, walls, substeps)
    if args.path.startswith("2d"):
        g = [r for r in rows if "pcdf2d_kernel" in r[2]]
        if not g:
            sys.exit("FAIL: kernel G (pcdf2d_kernel) did not launch")
        ms, count = sum(r[0] for r in g), sum(r[1] for r in g)
        print(f"kernel G (pcdf2d_kernel): {ms / substeps:.4f} ms a substep, "
              f"{count / substeps:.1f} launches a substep, {ms / count:.4f} ms a launch")
    r = [r for r in rows if "rigid_solve_kernel" in r[2]]
    if args.path in ("3d-dyn", "sand2"):
        if not r:
            sys.exit("FAIL: the rigid-solve kernel did not launch")
        ms, count = sum(x[0] for x in r), sum(x[1] for x in r)
        print(f"rigid solve (rigid_solve_kernel): {ms / substeps:.4f} ms a substep, "
              f"{count / substeps:.1f} launches a substep, {ms / count:.4f} ms a launch")
    if args.path in ("cut2", "cut3", "hf3", "hf3-sparse"):
        m = [r for r in rows if "mesh_cdf" in r[2]]
        if not m:
            sys.exit("FAIL: the mesh pass (mesh_cdf) did not launch")
        ms, count = sum(x[0] for x in m), sum(x[1] for x in m)
        print(f"mesh pass (mesh_cdf): {ms / substeps:.4f} ms a substep, "
              f"{count / substeps:.1f} launches a substep, {ms / count:.4f} ms a launch; "
              f"{state.meshes.count} samples")
        c = [r for r in rows if "update" in r[2] and "::" not in r[2]]
        m = state.models
        can = m.max_stretch > 0.0   # lanes that run the fracture check
        print(f"kernel C ({', '.join(x[2].split('(')[0] for x in c)}): "
              f"{sum(x[0] for x in c) / substeps:.4f} ms a substep; "
              f"{int((can & (m.phase == 0.0)).sum())} of {int(can.sum())} lanes "
              "with a fracture threshold fractured")

    if args.path in ("dense", "dense-2d", "blocked"):
        for name in ("dense_pcdf_kernel", "dense_p2g_nodes", "dense_p2g_impulses",
                     "dense_g2p_kernel"):
            k = [x for x in rows if name in x[2]]
            if not k:
                sys.exit(f"FAIL: {name} did not launch")
            ms, count = sum(x[0] for x in k), sum(x[1] for x in k)
            print(f"{name}: {ms / substeps:.4f} ms a substep, {count / substeps:.1f} "
                  f"launches a substep, {ms / count:.4f} ms a launch")

    if args.path in ("sparse", "hf3-sparse"):
        from wgsparkl_tpu_torch import pipeline
        from wgsparkl_tpu_torch.ops import blocked as bk
        from wgsparkl_tpu_torch.rigid import body as body_mod

        rec = {}
        step_pallas(state, params, cfg, 1, record=rec)
        bodies = body_mod.update_world_mass_properties(state.bodies)
        act = rec["act"]
        ms = chip_smoke.cuda_ms(
            lambda: pipeline._sparse_chan_grid(bodies, state.meshes, cfg, act), reps=20)
        n_act = int((act < bk.SPARSE_SENTINEL).sum())
        print(f"slot channel grid (_sparse_chan_grid, {cfg.num_colliders} colliders at "
              f"{act.shape[0] * 64} slot nodes, {n_act} slots active): {ms:.4f} ms a "
              f"call (CUDA events), {ms / (device_ms / substeps):.3f} of a substep's "
              "device time")


if __name__ == "__main__":
    main()
