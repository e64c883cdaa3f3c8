"""kernels.device_ms_per_substep: device time of the kernels whose names
are __global__ functions of wgsparkl_tpu_torch/csrc/*.cu, in the profiled
frames, over their substeps, in ms."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["device_us"]["kernels"]:
        return None
    return 1e-3 * ctx["device_us"]["kernels"] / ctx["profiled_substeps"]
