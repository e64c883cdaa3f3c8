"""Flagged-lane compaction (port of wgsparkl_tpu/ops/compact.py,
`compact_flagged`; kernel E, csrc/compact.cu).

Packs the values of flagged lanes to the front in lane order.  Its caller
on the main path is the block-boundary compaction of ops/blocked.py
`build_jobs`; the JAX package's second caller, the banded permute's
far-mover list, does not exist here (ops/permute.py is a plain gather).
"""

from __future__ import annotations

import torch

from wgsparkl_tpu_torch import _cuda
from wgsparkl_tpu_torch.ops.rows import check_kernel_args

PAD = float(2 ** 24)
TILE = 16384   # lanes a tile of the CUDA kernel (csrc/compact.cu TILE)
# Zeroed scratch of the CUDA kernel by (device, stream): a ticket, a done
# counter and one status word a tile.  The kernel leaves it zeroed again.
# A call under CUDA graph capture takes a scratch of its own instead (_scratch).
_SCRATCH = {}


def compact_plain(vals, flag, cap: int):
    r, n = vals.shape
    idx = torch.nonzero(flag).reshape(-1)
    k = min(idx.shape[0], cap)
    out = torch.full((r + 1, cap), PAD, dtype=torch.float32, device=vals.device)
    out[:r, :k] = vals[:, idx[:k]]
    out[r, :k] = idx[:k].to(torch.float32)
    return out, torch.as_tensor(idx.shape[0] <= cap, device=vals.device)


def _scratch(dev, ntiles: int):
    if torch.cuda.is_current_stream_capturing():
        # From the graph's pool, zeroed by a fill the graph replays before the
        # kernel: a kept one may be a dropped graph's that no replay zeroed.
        return torch.zeros(2 + ntiles, dtype=torch.int32, device=dev)
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.shape[0] < 2 + ntiles:
        # Grown by doubling; allocated zeroed once, outside the steady state.
        size = max(2 + ntiles, 2 * (0 if buf is None else buf.shape[0]))
        buf = _SCRATCH[key] = torch.zeros(size, dtype=torch.int32, device=dev)
    return buf


def compact_flagged(vals, flag, cap: int):
    """vals [R, N] integer-valued f32 (< 2^24), flag [N] bool, cap static
    output width -> (out [R + 1, cap], ok): rows 0..R-1 the compacted
    values, row R the flagged lanes' indices, columns past the flag count
    2^24; ok (0-d bool) is False when the flagged lanes exceed cap (the
    first cap of them are kept)."""
    if vals.device.type == "cpu":
        return compact_plain(vals, flag, cap)
    vals = vals.to(torch.float32).contiguous()
    flag = flag.to(torch.bool).contiguous()
    check_kernel_args(vals, flag)
    r, n = vals.shape
    if flag.shape != (n,) or cap < 0 or n >= 2 ** 30:
        raise ValueError(f"compact_flagged: flag [{n}] and 0 <= cap, N < 2^30 "
                         f"(got flag {tuple(flag.shape)}, cap {cap})")
    dev = vals.device
    out = torch.empty((r + 1, cap), dtype=torch.float32, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    _cuda.launch("compact", "compact_flagged_cuda", "ppiiippp",
                 vals, flag, r, n, cap, _scratch(dev, -(-n // TILE)), out, ok)
    compact_flagged.launches += 1
    return out, ok


compact_flagged.launches = 0
