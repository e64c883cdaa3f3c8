"""Spans and counters of the frame loop, off by default.

    from wgsparkl_tpu_torch.utils import tracing

    tracing.enable()
    MpmPipeline().step(data, 20)
    sessions = tracing.collect()
    tracing.disable()
    tracing.clear()

The tracer is on while a torch.profiler session runs, or between `enable()`
and `disable()`.  Off, `span` is one flag check that returns a shared null
context (about 0.3 us with its `with`) and `count` one flag check: no
record_function runs.

On, a span keeps a record in memory: its name, id, the id of the span it
opened in, the frame (the `mpm.frame` span's index in the session) and the
substep (the `mpm.substep` span's index in its frame) it ran in, and its
host start and end.  Under a profiler it also opens
`torch.profiler.record_function(name)` (a `user_annotation` event of the
trace), and its start is then the middle of record_function's entry, which
takes the trace's own timestamp, and its end follows the exit; without one
it opens none, which would record nothing and cost 7 us or more.  Host
times are on the Unix clock (`time.time_ns()`), which is the clock of a
profiler trace's events: an exported Chrome trace's `ts` plus its
`baseTimeNanoseconds / 1e3` (us).  A span opened with `device=True` on
work on the card also records a pair of CUDA events on the current stream
around its work (no kernel, copy or fill), which `collect()` resolves into
the device ms between them: the device's time from the first of the span's
operations to the last, any idle stretch between them included.

`count(name, value, most=None)` keeps a host int or a 0-d device tensor by
reference (no launch, no synchronise); the tensor is read at `collect()`,
clamped to `most` when given.

A session starts where a span or count finds the tracer on after finding it
off, or finds a profiler running where the session it is in began without
one (or the other way round), so the profiler passes run one after another
with some span or count in between fill separate sessions.  The tracer
holds at most LIMIT records (spans and counts) over its sessions; past that
a session counts what it drops in `dropped` (under a profiler its spans
still open their record_function).  `clear()` frees them.
"""

from __future__ import annotations

import itertools
import time

import torch
from torch.autograd import profiler as _prof

PREFIX = "mpm."          # of every span name the port opens
FRAME = PREFIX + "frame"
SUBSTEP = PREFIX + "substep"
LIMIT = 1 << 17


class _Null:
    """The shared context of a span while the tracer is off.  Its entry and
    exit are calls in C, cheaper than contextlib.nullcontext's: "".format
    takes any arguments and returns "", which is false, so an exception
    passes through."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


_NULL = _Null()
_enabled = False
_cur = None           # the session being filled, None while off
_sessions = []
_held = 0             # records held over the sessions
_stack = []           # ids of the open spans, innermost last
_ids = itertools.count()
_pool = []            # CUDA timing events, reused after collect()


class _Session:
    def __init__(self, profiler: bool):
        self.profiler = profiler
        self.spans = []       # [name, id, parent, frame, substep, start_ns, end_ns, dev]
        self.counts = []      # [name, value, most]
        self.frames = 0
        self.frame = -1
        self.substep = -1
        self.dropped = 0


def enable():
    """Turns the tracer on until disable(), profiler or not; a new session
    starts."""
    global _enabled, _cur
    _enabled, _cur = True, None


def disable():
    """Turns the tracer off again, but while a profiler runs."""
    global _enabled, _cur
    _enabled, _cur = False, None


def clear():
    """Drops every session held, with the events of spans collect() has
    not resolved."""
    global _cur, _held
    _sessions.clear()
    _cur, _held = None, 0


def _session() -> _Session:
    global _cur
    prof = _prof._is_profiler_enabled
    if _cur is None or _cur.profiler != prof:
        _cur = _Session(prof)
        _sessions.append(_cur)
    return _cur


def _full(s: _Session) -> bool:
    global _held
    if _held >= LIMIT:
        s.dropped += 1
        return True
    _held += 1
    return False


class _Span:
    __slots__ = ("name", "device", "rf", "rec", "ev", "session")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self):
        s = self.session = _session()
        start = time.time_ns()
        self.rf = None
        if s.profiler:
            self.rf = _prof.record_function(self.name)
            self.rf.__enter__()
            start = (start + time.time_ns()) // 2
        self.rec = self.ev = None
        if _full(s):
            return self
        if self.name == FRAME:
            s.frame, s.substep = s.frames, -1
            s.frames += 1
        elif self.name == SUBSTEP:
            s.substep += 1
        sid = next(_ids)
        if self.device:
            self.ev = (_pool.pop() if _pool else torch.cuda.Event(enable_timing=True),
                       _pool.pop() if _pool else torch.cuda.Event(enable_timing=True))
            self.ev[0].record()
        self.rec = [self.name, sid, _stack[-1] if _stack else None, s.frame, s.substep,
                    start, None, self.ev]
        s.spans.append(self.rec)
        _stack.append(sid)
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            if self.ev is not None:
                self.ev[1].record()
            _stack.pop()
            if self.name == FRAME:
                self.session.frame = -1
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.rec is not None:
            self.rec[6] = time.time_ns()
        return False


def active() -> bool:
    """Whether the tracer is on: enable()d, or under a profiler."""
    return _enabled or _prof._is_profiler_enabled


def span(name: str, device: bool = False):
    """A context manager timing its block as `name` while the tracer is on
    (device: also CUDA events around its work on the card; pass False for
    work on the CPU); the shared null context while it is off."""
    global _cur
    if _enabled or _prof._is_profiler_enabled:
        return _Span(name, device)
    _cur = None
    return _NULL


def count(name: str, value, most=None):
    """Records `value` (a host int or a 0-d tensor, read at collect()) under
    `name` while the tracer is on."""
    global _cur
    if not (_enabled or _prof._is_profiler_enabled):
        _cur = None
        return
    s = _session()
    if not _full(s):
        s.counts.append([name, value, most])


def _resolve(sessions):
    """Device events into ms and tensors into ints, in place (one
    synchronise first where any is pending); the events go back to the
    pool."""
    pending = any(isinstance(r[7], tuple) and r[6] is not None
                  for s in sessions for r in s.spans)
    if pending or any(torch.is_tensor(c[1]) and c[1].is_cuda
                      for s in sessions for c in s.counts):
        torch.cuda.synchronize()
    for s in sessions:
        for r in s.spans:
            if isinstance(r[7], tuple) and r[6] is not None:
                r[7], ev = r[7][0].elapsed_time(r[7][1]), r[7]
                _pool.extend(ev)
        for c in s.counts:
            if torch.is_tensor(c[1]):
                c[1] = int(c[1])
            if c[2] is not None:
                c[1], c[2] = min(c[1], c[2]), None


def collect() -> list:
    """The sessions held, oldest first, each a dict: `profiler` (whether it
    began under a profiler), `frames`, `dropped`, `spans` (the closed ones,
    in opening order: name, id, parent, frame, substep, start_us and end_us
    on the Unix clock, host_ms, self_ms (host_ms less its children's),
    device_ms (None without device markers)) and `counters` ({name: values
    in order}).  Calling it again returns the same records and any new."""
    _resolve(_sessions)
    out = []
    for s in _sessions:
        spans = [r for r in s.spans if r[6] is not None]
        child_ns = {}
        for r in spans:
            if r[2] is not None:
                child_ns[r[2]] = child_ns.get(r[2], 0) + r[6] - r[5]
        counters = {}
        for name, value, _ in s.counts:
            counters.setdefault(name, []).append(value)
        out.append({
            "profiler": s.profiler, "frames": s.frames, "dropped": s.dropped,
            "spans": [{"name": r[0], "id": r[1], "parent": r[2], "frame": r[3],
                       "substep": r[4], "start_us": r[5] / 1e3, "end_us": r[6] / 1e3,
                       "host_ms": (r[6] - r[5]) / 1e6,
                       "self_ms": (r[6] - r[5] - child_ns.get(r[1], 0)) / 1e6,
                       "device_ms": r[7]} for r in spans],
            "counters": counters})
    return out
