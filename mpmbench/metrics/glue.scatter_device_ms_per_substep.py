"""glue.scatter_device_ms_per_substep: the device time between the CUDA
event markers of the program's `mpm.scatter` spans (the window scatter,
`ops/blocked.scatter_tiles`, and the sparse ghost's zeroing) in the
device-only pass's profiled frames, over their substeps, in ms.  The same
span whatever implements the scatter; the markers also hold any idle
stretch between the span's first and last device operation."""

from mpmbench import spans


def read(ctx):
    return spans.per_substep(ctx, ("mpm.scatter",), "device_ms")
