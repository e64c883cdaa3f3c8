"""Per-op time breakdown of one frame from a torch.profiler trace (port of
wgsparkl_tpu/utils/profiling.py):

    from wgsparkl_tpu_torch.utils.profiling import profile_step, print_table
    rows = profile_step(data, num_substeps=20)
    print_table(rows)

Each row is (total_ms, ms_per_substep, op, source, code).  On the card the
ops are the device's kernels, copies and fills by self device time; a
hand-written kernel's source is its `__global__` line in csrc/.  On the CPU
the ops are the PyTorch operators by self CPU time, each attributed to the
innermost function of this package that called it (its def line).  (tools/torch_profile.py
prints a fuller report of the same trace for chip_smoke.py's paths.)
"""

from __future__ import annotations

import collections
import linecache
import os
import pathlib
import re
import time

import torch

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_ROOT = str(pathlib.Path(__file__).resolve().parent.parent.parent)
_FRAME = re.compile(r"^(.*)\((\d+)\): (.*)$")


def _kernel_sources():
    """{kernel symbol: (csrc path, line)} of the hand-written kernels."""
    out = {}
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)")
    for src in sorted(_CSRC.glob("*.cu")):
        text = src.read_text()
        for m in pat.finditer(text):
            out.setdefault(m.group(1), (str(src), text.count("\n", 0, m.start(1)) + 1))
    return out


def _symbol(key: str) -> str:
    """The function name of a profiler kernel key ("void name<...>(...)")."""
    m = re.match(r"(?:void\s+)?([\w:]+)", key)
    return m.group(1) if m else key


def _own_frame(event):
    """(path, line) of the innermost function of this package enclosing a
    profiled operator (its def line: the profiler records Python calls)."""
    e = event.cpu_parent
    while e is not None:
        m = _FRAME.match(e.name)
        if m and m.group(1).startswith("wgsparkl_tpu_torch/"):
            return os.path.join(_ROOT, m.group(1)), int(m.group(2))
        e = e.cpu_parent
    return None


def _location(src):
    if src is None:
        return "", ""
    path, line = src
    return (f"{os.path.basename(path)}:{line}",
            linecache.getline(path, line).strip()[:80])


def profile_step(data, num_substeps: int = 20, top: int = 40,
                 warmup_frames: int = 1, stats: dict | None = None):
    """Profile one frame of `data` (an MpmData) after `warmup_frames`
    unprofiled ones; returns up to `top` rows, largest first.  `stats`, when
    given, receives the profiled frame's own wall time (`wall_ms`, the
    device synchronised before and after it, the profiler on)."""
    from wgsparkl_tpu_torch.pipeline import step

    cfg = data.config
    on_card = data.state.particles.pos.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    state = data.state
    for _ in range(warmup_frames):
        state = step(state, data.params, cfg, num_substeps)
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts, with_stack=not on_card,
                                acc_events=True) as prof:
        t0 = time.perf_counter()
        step(state, data.params, cfg, num_substeps)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if stats is not None:
        stats["wall_ms"] = wall_ms
    by_op = collections.Counter()
    where = {}
    if on_card:
        kernels = _kernel_sources()
        for e in prof.key_averages():
            if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            if us > 0:
                by_op[e.key] += us
                where[e.key] = kernels.get(_symbol(e.key))
    else:
        for e in prof.events():
            if e.self_cpu_time_total > 0 and not _FRAME.match(e.name):
                src = _own_frame(e)
                key = (e.name, src)
                by_op[key] += e.self_cpu_time_total
                where[key] = src
    rows = []
    for key, us in by_op.most_common(top):
        loc, code = _location(where[key])
        op = key if on_card else key[0]
        rows.append((us / 1e3, us / 1e3 / num_substeps, op[:40], loc, code))
    return rows


def print_table(rows, min_ms_per_substep: float = 0.05):
    total = sum(r[1] for r in rows)
    print(f"{'ms/substep':>10}  {'op':<40}  {'source':<28}  code")
    for _, per, op, loc, code in rows:
        if per < min_ms_per_substep:
            continue
        print(f"{per:10.3f}  {op:<40}  {loc:<28}  {code}")
    print(f"{total:10.3f}  (sum of the listed ops)")
