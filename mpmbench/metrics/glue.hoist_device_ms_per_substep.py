"""glue.hoist_device_ms_per_substep: the device time between the CUDA
event markers of the program's `mpm.hoist` spans (each frame's hoist of
the static colliders' node CDF and channel grid, `_frame_pallas`) in the
device-only pass's profiled frames, over their substeps, in ms.  The span
opens in every kernel-path frame; where the frame hoists nothing (a scene
whose only static colliders are meshes, rebuilt every substep) its
markers hold no work and it reads their own gap."""

from mpmbench import spans


def read(ctx):
    return spans.per_substep(ctx, ("mpm.hoist",), "device_ms")
