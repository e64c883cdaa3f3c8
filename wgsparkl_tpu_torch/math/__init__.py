import torch


def div(a, b):
    """IEEE a / b where one side is a Python scalar.

    PyTorch evaluates `scalar / tensor` everywhere, and `tensor / scalar` on
    CUDA, as a product with a reciprocal, which rounds differently from a
    division; the CUDA kernels and the JAX package divide."""
    t = a if isinstance(a, torch.Tensor) else b
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=t.dtype, device=t.device)
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=t.dtype, device=t.device)
    return torch.div(a, b)


# The JAX package's exports (after div, which the modules below may import).
from wgsparkl_tpu_torch.math.svd import recompose, svd, svd2x2, svd3x3  # noqa: E402
from wgsparkl_tpu_torch.math import pose  # noqa: E402

__all__ = ["div", "svd2x2", "svd3x3", "svd", "recompose", "pose"]
