"""device.launches_per_substep: device operations (kernels, copies, fills)
in the profiled frames over their substeps: a count, which repeats."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device:
        return None
    return len(tr.device) / ctx["profiled_substeps"]
