"""glue.gather_device_ms_per_substep: the device time between the CUDA
event markers of the program's window gathers, `mpm.gather_nodes` (the
node-CDF tiles, in the CDF phase) and `mpm.gather_grid` (the grid tiles
for G2P), in the device-only pass's profiled frames, over their substeps,
in ms."""

from mpmbench import spans


def read(ctx):
    return spans.per_substep(ctx, ("mpm.gather_nodes", "mpm.gather_grid"), "device_ms")
