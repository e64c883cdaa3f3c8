"""glue.device_ms_per_substep: device time of every device operation that
is not a kernel of wgsparkl_tpu_torch/csrc (PyTorch's kernels, copies and
fills) in the profiled frames, over their substeps, in ms."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device:
        return None
    return 1e-3 * ctx["device_us"]["glue"] / ctx["profiled_substeps"]
