"""device.idle_share: 1 - the union of the device's busy intervals over the
wall of the same profiled frames (first frame's call to the last one's
synchronise), in %."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
