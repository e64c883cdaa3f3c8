"""pipeline.cdf_host_ms_per_substep: the host time of the program's
`mpm.cdf` spans (the node CDF, the mesh pass, the channel grid, the node
gather and the gate; in 2D kernel G's particle CDF too) in the device-only
pass's profiled frames, over their substeps, in ms.  That pass records
every launch through CUPTI, which slows the host (about +35% on cut2's
frames): compare it between runs, not with the window's host time."""

from mpmbench import spans


def read(ctx):
    return spans.per_substep(ctx, ("mpm.cdf",), "host_ms")
