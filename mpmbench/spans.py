"""The program's own spans and counters (wgsparkl_tpu_torch.utils.tracing)
for the per-layer metrics that read them.  They read the run's first
tracer session: the tracer is off in the window and on while a profiler
runs, so in a traced run that is the device-only pass (mpmbench/run.py's
`_trace` profiles it first).  A program without the tracer gives nothing
to read, and the readers return None."""


def first_session(ctx):
    """The run's first tracer session, or None (an untraced run, a program
    without the tracer, no session)."""
    if ctx.get("trace") is None:
        return None
    try:
        from wgsparkl_tpu_torch.utils import tracing
    except ImportError:
        return None
    sessions = tracing.collect()
    return sessions[0] if sessions else None


def per_substep(ctx, names, key):
    """The sum of `key` ("host_ms" or "device_ms") of the first session's
    spans named in `names` over the session's substeps (its `mpm.substep`
    spans), or None where a span lacks it (device markers on the CPU) or
    none ran."""
    s = first_session(ctx)
    if s is None:
        return None
    substeps = sum(1 for sp in s["spans"] if sp["name"] == "mpm.substep")
    values = [sp[key] for sp in s["spans"] if sp["name"] in names]
    if not substeps or not values or any(v is None for v in values):
        return None
    return sum(values) / substeps
