"""Start the ranks of a multi-device run, and the rank job that steps a shard.

`run` starts `world` processes with torch.multiprocessing's "spawn"
context.  Each joins a process group through `init_method="file://..."` on
a file in a temporary directory (no TCP port to collide with another run
on the same host), builds its `Comm`, and calls `fn(comm, device, *args)`;
its result goes back to the parent, which returns the ranks' results in
rank order.  A rank on the CPU runs one thread (`torch.set_num_threads(1)`).

A spawned rank starts from a fresh interpreter and imports the module that
holds `fn`, so rank functions live in importable modules (here: `step_job`)
that import neither JAX nor any test module.  The CUDA kernels are built
by the parent before it spawns (`_cuda.build`): a rank loads the built
libraries and runs no compiler.  A rank that fails makes `run` raise with
its traceback; every process `run` started has ended when it returns.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from wgsparkl_tpu_torch.parallel.comm import Comm, check_devices


def _rank_main(rank, world, backend, init, device, fn, args, setup, out):
    """One rank: fn(comm, device, *args) after its group is up."""
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
        else:
            torch.set_num_threads(1)
        if setup is not None:
            setup()
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world)
        try:
            result = fn(Comm(rank, world, backend), torch.device(device), *args)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            dist.barrier()
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def run(fn, world: int, args=(), rank_args=None, backend: str = "gloo",
        devices=None, setup=None, timeout: float = 900.0):
    """fn(comm, device, *rank_args[rank], *args) on `world` spawned ranks;
    their results in rank order.  devices: one a rank (default: the CPU for
    every rank); setup: a picklable callable each rank runs first (before
    its group)."""
    devices = list(devices or ["cpu"] * world)
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    check_devices(backend, devices)
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    results, procs = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        try:
            for r in range(world):
                own = tuple(rank_args[r]) if rank_args is not None else ()
                p = ctx.Process(target=_rank_main, args=(
                    r, world, backend, init, str(devices[r]), fn, own + tuple(args),
                    setup, out))
                p.start()
                procs.append(p)
            deadline = time.time() + timeout
            while len(results) < world:
                try:
                    rank, ok, value = out.get(timeout=1.0)
                except queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"a rank died (exit codes {dead})") from None
                    if time.time() > deadline:
                        raise TimeoutError(f"ranks still running after {timeout} s") \
                            from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                results[rank] = value
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
    return [results[r] for r in range(world)]


def step_job(comm, device, shard, params, cfg, frames, after=None):
    """Rank job: this rank's shard (a SimState, see domain.map_state) moved
    to `device` and stepped by make_sharded_step, frame after frame
    (frames: the substeps of each), the launch counts set to 0 just before
    the first frame and read just after the last.  Returns a dict: the
    shard after each frame (numpy leaves), each frame's StepDiag ([world]
    vectors, as numpy), its seconds (host clock, synchronised), the launch
    counts, and after(comm, shard, params, cfg) on the last shard (None
    without)."""
    import wgsparkl_tpu_torch as wt
    from wgsparkl_tpu_torch.parallel.domain import make_sharded_step, map_state

    state = map_state(lambda t: torch.as_tensor(t).to(device), shard)
    params = dataclasses.replace(params, gravity=params.gravity.to(device))
    states, diags, seconds = [], [], []
    wt.reset_launch_counts()
    for substeps in frames:
        t0 = time.time()
        state, diag = make_sharded_step(cfg, comm, substeps, with_diag=True)(
            state, params)
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds.append(time.time() - t0)
        states.append(map_state(lambda t: t.cpu().numpy(), state))
        diags.append({f.name: getattr(diag, f.name).cpu().numpy()
                      for f in dataclasses.fields(diag)})
    counts = wt.launch_counts()
    extra = after(comm, state, params, cfg) if after is not None else None
    return {"states": states, "diags": diags, "seconds": seconds,
            "launches": counts, "after": extra}


def step_jobs(comm, device, jobs):
    """step_job on each of jobs, (shard, params, cfg, frames[, after]) for
    this rank, in order (one launch for several runs)."""
    return [step_job(comm, device, *job) for job in jobs]


def unit_job(comm, device, units):
    """Rank job of the exchange units, for their tests: units is a list of
    (unit, kw), kw this rank's numpy inputs; returns each unit's outputs
    as numpy, in order.  unit:
      * "migrate": `_migrate_x` on rows [C, NPAD] sorted first by the keys
        of row kw["key_row"] (lanes of mass 0 last), between the sorts that
        a substep makes; returns the migrated, sorted rows, their keys and
        migration_dropped;
      * "halo_x": `_halo_exchange_x` on the grid kw["grid"] (p2, wx);
      * "halo_sparse": `_halo_exchange_sparse` on the slot grid kw["grid"]
        and the active table kw["act"] (amax, lo_key, hi_key, halo_cap);
        returns the grid and halo_dropped."""
    return [_unit(comm, device, unit, kw) for unit, kw in units]


def _unit(comm, device, unit, kw):
    from wgsparkl_tpu_torch import pipeline as P

    diag = P.StepDiag.zeros(device)
    grid = torch.as_tensor(kw["grid"], device=device) if "grid" in kw else None
    if unit == "halo_x":
        return P._halo_exchange_x(grid, kw["p2"], comm.rank, kw["wx"], comm).cpu().numpy()
    if unit == "halo_sparse":
        act = torch.as_tensor(kw["act"], device=device)
        out = P._halo_exchange_sparse(grid, act, kw["amax"], kw["lo_key"], kw["hi_key"],
                                      kw["halo_cap"], comm, diag)
        return out.cpu().numpy(), int(diag.halo_dropped)
    if unit != "migrate":
        raise ValueError(f"unknown unit {unit!r}")
    rows = torch.as_tensor(kw["rows"], device=device)
    pm, live = kw["pm"], kw["live_key"]

    def sort_rows(r):
        keys = torch.where(r[pm] > 0.0, r[kw["key_row"]].to(torch.int32), live + 1)
        sids, perm = torch.sort(keys, stable=True)
        return r, r[:, perm], sids, perm.to(torch.int32)

    _, rows, sids, _ = sort_rows(rows)
    _, rows, sids, _ = P._migrate_x(rows, sids, kw["lo_key"], kw["hi_key"], live,
                                    kw["capx"], comm, diag, sort_rows, pm)
    return rows.cpu().numpy(), sids.cpu().numpy(), int(diag.migration_dropped)
