"""glue.live_job_share: the job slots that hold a job (the program's
counter `jobs.live`, the job table's needed jobs clamped to its size) over
the slots the window scatter reads (`jobs.slots`), summed over the
device-only pass's profiled substeps, in %: the share of the scatter's
work that is live."""

from mpmbench import spans


def read(ctx):
    s = spans.first_session(ctx)
    if s is None:
        return None
    live = sum(s["counters"].get("jobs.live", []))
    slots = sum(s["counters"].get("jobs.slots", []))
    return 100.0 * live / slots if slots else None
