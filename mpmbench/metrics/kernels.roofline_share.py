"""kernels.roofline_share: the sum of the hand-written kernels' bounds
(mpmbench/costs.py, from each profiled substep's own counts) over their
device time in the profiled frames, in %.  Nothing to read, nothing
returned: never 0."""


def read(ctx):
    tr = ctx["trace"]
    dev_us = ctx["device_us"]["kernels"] if tr is not None else 0.0
    bound_ms = sum(ctx.get("bound_ms", {}).values())
    if not dev_us or not bound_ms:
        return None
    return 100.0 * bound_ms * 1e3 / dev_us
