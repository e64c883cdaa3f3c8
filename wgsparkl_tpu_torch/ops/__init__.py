from wgsparkl_tpu_torch.ops.kernel import (
    eval_all,
    inv_d,
    stencil_base_and_weights,
    stencil_offsets,
)

__all__ = ["eval_all", "inv_d", "stencil_base_and_weights", "stencil_offsets"]
