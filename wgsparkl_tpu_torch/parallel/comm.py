"""The collectives of the multi-device step, on torch.distributed.

The JAX package takes them from XLA inside `shard_map`; this module gives
the port the three it uses (wgsparkl_tpu/pipeline.py, parallel/domain.py):

  * `psum`, the sum over ranks (`jax.lax.psum`, an all-reduce of SUM);
  * `shift`, the move to the right or left neighbour (`jax.lax.ppermute`
    with pairs (i, i + 1) or (i, i - 1)), a point-to-point send and
    receive; a rank with no source receives zeros, as ppermute gives, and
    the halo exchange and the migration rely on those zeros at the edge
    ranks;
  * `rank`, the position on the axis (`jax.lax.axis_index`).

The backend is the caller's and nothing switches it:

  * "nccl" takes CUDA tensors, one card a rank; two ranks on one device
    raise (`check_devices`);
  * "gloo" takes CPU tensors.  Given CUDA tensors it stages each buffer
    explicitly through pinned host memory (copy out, the collective on the
    host copy, copy back), which is how several ranks share one card.

A sum gives every rank the same bits on either backend: the ranks'
addends are all-gathered and every rank adds them in rank order, so the
bodies, updated on every rank from the summed impulses, never drift apart
whatever order the backend's own reduction would take.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def check_devices(backend: str, devices) -> None:
    """Raise unless `devices` (one a rank) suit `backend`: NCCL needs a
    distinct CUDA device for each rank, gloo takes any."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")
    if backend != "nccl":
        return
    devs = [torch.device(d) for d in devices]
    if any(d.type != "cuda" for d in devs):
        raise ValueError(f"nccl takes CUDA devices, got {devs}")
    if len(set(devs)) != len(devs):
        raise ValueError(f"nccl needs one card a rank; two ranks share a device in "
                         f"{devs} (use gloo, which stages through the host)")


class Comm:
    """This rank's view of a 1D axis of `world` ranks over a process group
    (None: the default group) of `backend`."""

    def __init__(self, rank: int, world: int, backend: str, group=None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")
        self.rank, self.world, self.backend, self.group = rank, world, backend, group

    def _out(self, x):
        """x as the collective takes it: a pinned host copy of a CUDA tensor
        under gloo, else x itself (contiguous)."""
        if self.backend == "gloo" and x.is_cuda:
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            h.copy_(x)
            return h
        if self.backend == "nccl" and not x.is_cuda:
            raise ValueError("nccl takes CUDA tensors")
        return x.contiguous()

    def _buffer(self, x):
        """An empty buffer like x where the collective writes."""
        if self.backend == "gloo" and x.is_cuda:
            return torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return torch.empty_like(x, memory_format=torch.contiguous_format)

    def gather(self, x):
        """[world, *x.shape]: every rank's x, in rank order (on x's device)."""
        parts = [self._buffer(x) for _ in range(self.world)]
        dist.all_gather(parts, self._out(x), group=self.group)
        out = torch.empty((self.world,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        for r, part in enumerate(parts):
            out[r].copy_(part)      # pinned host -> device, no pageable hop
        return out

    def psum(self, x):
        """The sum of x over ranks, the same bits on every rank."""
        parts = self.gather(x)
        out = parts[0].clone()
        for r in range(1, self.world):
            out += parts[r]
        return out

    def shift(self, x, step: int):
        """What rank - step sent: x goes to rank + step; a rank with no
        source (step +1: rank 0; step -1: the last) receives zeros."""
        src, dst = self.rank - step, self.rank + step
        ops, recv = [], None
        if 0 <= dst < self.world:
            ops.append(dist.P2POp(dist.isend, self._out(x), dst, self.group))
        if 0 <= src < self.world:
            recv = self._buffer(x)
            ops.append(dist.P2POp(dist.irecv, recv, src, self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if recv is None:
            return torch.zeros_like(x)
        return recv.to(x.device)
