"""Profiler trace of a few frames and its reduction to device intervals.

`profile(run_frame, frames, tmpdir, host)` runs the frames (each ends in
its synchronise) under torch.profiler, exports the trace to a file in
tmpdir, reads it and deletes it.  The result (`Trace`) holds the device
events (kernels, copies, fills) of the frames and the window's length.

  host=False  the device's activity alone (CUPTI's records of kernels,
              copies and fills; the host runs as it does unprofiled, but
              for the launches' records): the window is the host clock
              from the first frame's call, the device idle, to the last
              frame's synchronise;
  host=True   the host's operations too, each frame inside a
              "mpmbench.frame" span: the window is the first span's start
              to the last one's end, and the host events say what the host
              did in each idle gap.  Recording every host operation slows
              the host, so this pass serves the idle gaps' breakdown alone.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
SPAN = "mpmbench.frame"


@dataclasses.dataclass
class Trace:
    device: list          # (name, cat, start_us, dur_us) inside the window
    host: list            # (name, start_us, dur_us); empty without the host pass
    t0: float             # window start, us (trace clock)
    t1: float             # window end, us
    frames: int
    wall_s: float = None  # the window by the host clock (host=False)

    @property
    def window_s(self) -> float:
        return self.wall_s if self.wall_s is not None else (self.t1 - self.t0) * 1e-6

    def busy_intervals(self):
        """The union of the device events' intervals, clipped to the window."""
        iv = sorted((max(s, self.t0), min(s + d, self.t1)) for _, _, s, d in self.device)
        out = []
        for s, e in iv:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def gaps(self):
        """(start_us, length_us) of the window's idle stretches."""
        iv = self.busy_intervals()
        edges = [self.t0] + [x for s, e in iv for x in (s, e)] + [self.t1]
        return [(edges[i], edges[i + 1] - edges[i]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def host_at(self, t: float) -> str:
        """The innermost host event running at time t (host events nest:
        the latest-starting one that still runs), or "python (no op)": the
        interpreter between operations."""
        if not hasattr(self, "_starts"):
            self.host.sort(key=lambda e: e[1])
            self._starts = [s for _, s, _ in self.host]
        i = bisect.bisect_right(self._starts, t) - 1
        for j in range(i, max(i - 4096, -1), -1):
            name, s, d = self.host[j]
            if s + d > t:
                return name
        return "python (no op)"


def kernel_names(src_dir) -> dict:
    """{__global__ function name: its source's stem} of the .cu and .cuh
    files."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
    out = {}
    for name in sorted(os.listdir(src_dir)):
        stem, ext = os.path.splitext(name)
        if ext in (".cu", ".cuh"):
            with open(os.path.join(src_dir, name)) as f:
                for fn in pat.findall(f.read()):
                    out[fn] = stem
    return out


def source_of(event_name: str, names: dict):
    """The csrc stem of a device event's kernel name, or None (glue)."""
    for fn, stem in names.items():
        if re.search(rf"(?<![A-Za-z0-9_]){re.escape(fn)}(?![A-Za-z0-9_])", event_name):
            return stem
    return None


def profile(run_frame, frames: int, tmpdir: str, host: bool) -> Trace:
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CUDA] if cuda else []
    if host or not cuda:
        acts.append(ProfilerActivity.CPU)
    with tprofile(activities=acts) as prof:
        if cuda:
            torch.cuda.synchronize()
        t_start = time.perf_counter()
        for _ in range(frames):
            if host:
                with record_function(SPAN):
                    run_frame()
            else:
                run_frame()
        wall = time.perf_counter() - t_start
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmpdir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if host:
        spans = [e for e in xs if e.get("name") == SPAN
                 and e.get("cat") in ("user_annotation", "cpu_op")]
    else:
        spans = [e for e in xs if e.get("cat") in DEVICE_CATS]
    if not spans:
        return Trace([], [], 0.0, 0.0, frames, wall)
    t0 = min(float(e["ts"]) for e in spans)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    dev, host_ev = [], []
    for e in xs:
        s, d = float(e["ts"]), float(e["dur"])
        if s + d < t0 or s > t1:
            continue
        if e.get("cat") in DEVICE_CATS:
            dev.append((e["name"], e["cat"], s, d))
        elif e.get("cat") in HOST_CATS and e["name"] != SPAN:
            host_ev.append((e["name"], s, d))
    return Trace(dev, host_ev, t0, t1, frames, None if host else wall)


def breakdown(tr: Trace, host_tr: Trace) -> dict:
    """The device operations that took most time (tr, the device pass) and
    the longest idle time by what the host was doing (host_tr, the pass
    with the host's operations), ten of each, in seconds."""
    by_op = {}
    for name, _, s, d in tr.device:
        by_op[name] = by_op.get(name, 0.0) + d * 1e-6
    by_host = {}
    for s, length in host_tr.gaps():
        key = host_tr.host_at(s + 0.5 * length)
        by_host[key] = by_host.get(key, 0.0) + length * 1e-6
    top = lambda dct: [[k[:160], v] for k, v in sorted(dct.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"device_ops": top(by_op), "idle_gaps": top(by_host)}
