"""pipeline.jobs_host_ms_per_substep: the host time of the program's
`mpm.jobs` spans (the sort and the job table, `pipeline._job_phase`) in
the device-only pass's profiled frames, over their substeps, in ms.  That
pass records every launch through CUPTI, which slows the host (about +35%
on cut2's frames): compare it between runs, not with the window's host
time."""

from mpmbench import spans


def read(ctx):
    return spans.per_substep(ctx, ("mpm.jobs",), "host_ms")
