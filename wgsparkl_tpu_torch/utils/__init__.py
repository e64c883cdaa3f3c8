from wgsparkl_tpu_torch.utils.timing import Timestamps, time_passes
from wgsparkl_tpu_torch.utils import checkpoint, diagnostics

__all__ = ["Timestamps", "time_passes", "checkpoint", "diagnostics"]
