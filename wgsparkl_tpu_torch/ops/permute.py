"""Lane permutation of the row matrix (port of wgsparkl_tpu/ops/permute.py,
`permute_lanes`; kernel D, csrc/permute.cu).

The TPU version moves rows[:, perm] as a banded one-hot matmul with shift
classes and exception levels; on Hopper it is a column gather that reads
perm once, 16 bytes at a time, and stores 16 bytes per channel."""

from __future__ import annotations

import torch

from wgsparkl_tpu_torch import _cuda
from wgsparkl_tpu_torch.ops.rows import check_kernel_args


def permute_plain(rows, perm):
    return rows[:, perm.to(torch.int64)]


def permute_lanes(rows, perm):
    """rows[:, perm] for a [C, NPAD] f32 matrix and an int32 permutation."""
    if rows.device.type == "cpu":
        return permute_plain(rows, perm)
    if rows.dtype != torch.float32 or perm.dtype != torch.int32:
        raise TypeError("permute_lanes takes f32 rows and an int32 perm")
    check_kernel_args(rows, perm)
    c, npad = rows.shape
    if perm.shape != (npad,) or perm.data_ptr() % 16:
        raise ValueError(f"perm: a 16-byte aligned ({npad},) tensor, got shape "
                         f"{tuple(perm.shape)}")
    out = torch.empty_like(rows)
    _cuda.launch("permute", "permute_lanes_cuda", "ppiip", rows, perm, c, npad,
                 out)
    permute_lanes.launches += 1
    return out


permute_lanes.launches = 0
