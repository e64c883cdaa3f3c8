"""kernels.moving_job_share: the live jobs at gate level 2 in the
gathered-hybrid CDF mode (the program's counter `jobs.moving`), where
kernels A and B also evaluate the moving colliders at the job's window
nodes, over the live jobs (`jobs.live`), summed over the device-only
pass's profiled substeps, in %.  None where the program counts no such
jobs (the dense mode, a scene with no moving collider, a program without
the counter)."""

from mpmbench import spans


def read(ctx):
    s = spans.first_session(ctx)
    if s is None or "jobs.moving" not in s["counters"]:
        return None
    live = sum(s["counters"].get("jobs.live", []))
    return 100.0 * sum(s["counters"]["jobs.moving"]) / live if live else None
