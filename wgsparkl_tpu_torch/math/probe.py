"""The in-kernel f32 math probe (port of tools/probe_mosaic_math.py
`kernel`; csrc/math_probe.cu): nine elementwise expressions of x and y,
computed by a CUDA kernel built under the package's rounding contract
(-fmad=false, IEEE division and sqrt) and by the PyTorch calls the plain
versions use, so that the two can be held against float64 and against each
other bit for bit (tools/probe_cuda_math.py)."""

from __future__ import annotations

import numpy as np
import torch

from wgsparkl_tpu_torch import _cuda
from wgsparkl_tpu_torch.device import resolve

NAMES = ("recip", "recip_nr", "div", "sqrt", "rsqrt", "rsqrt_nr",
         "sqrt_via_rsqrt", "exp_log_sqrt", "log")


def probe_inputs(device=None):
    """The TPU probe's inputs: numpy default_rng(0), x = exp(U(-8, 8)) and
    y = exp(U(-4, 4)), each [8, 512] f32, on `device` (None: the card)."""
    device = resolve(device)
    rng = np.random.default_rng(0)
    x = np.float32(np.exp(rng.uniform(-8, 8, size=(8, 512)))).astype(np.float32)
    y = np.float32(np.exp(rng.uniform(-4, 4, size=(8, 512)))).astype(np.float32)
    return torch.as_tensor(x, device=device), torch.as_tensor(y, device=device)


def float64_reference(x, y):
    """[9, ...] float64 values of the nine expressions (NAMES order)."""
    x64, y64 = x.double(), y.double()
    r, rs = 1.0 / x64, 1.0 / torch.sqrt(x64)
    return torch.stack([r, r, y64 / x64, torch.sqrt(x64), rs, rs, torch.sqrt(x64),
                        torch.sqrt(x64), torch.log(x64)])


def math_probe_plain(x, y):
    """[9, ...] f32: the nine expressions as PyTorch calls (1/x, y/x,
    torch.sqrt, torch.rsqrt, torch.exp, torch.log)."""
    r = 1.0 / x
    rs = torch.rsqrt(x)
    return torch.stack([r, r * (2.0 - x * r), y / x, torch.sqrt(x), rs,
                        rs * (1.5 - 0.5 * x * rs * rs), x * rs,
                        torch.exp(torch.log(x) * 0.5), torch.log(x)])


def math_probe(x, y):
    """[9, ...] f32 (NAMES order) from the CUDA kernel for CUDA tensors,
    from math_probe_plain for CPU ones."""
    if x.device.type == "cpu":
        return math_probe_plain(x, y)
    if x.shape != y.shape or x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError("math_probe: two f32 tensors of one shape")
    x, y = x.contiguous(), y.contiguous()
    out = torch.empty((9,) + tuple(x.shape), dtype=torch.float32, device=x.device)
    _cuda.launch("math_probe", "math_probe_cuda", "ppip", x, y, x.numel(), out)
    math_probe.launches += 1
    return out


math_probe.launches = 0


def probe_table(device=None):
    """The probe's table as printable lines: per expression the kernel's
    and the PyTorch calls' largest relative error against float64, and how
    many elements differ in bits between the two (one kernel launch on
    `device`; None: the card)."""
    x, y = probe_inputs(device)
    k, p = math_probe(x, y), math_probe_plain(x, y)
    ref = float64_reference(x, y)
    ek = (k.double() - ref).abs() / ref.abs()
    ep = (p.double() - ref).abs() / ref.abs()
    lines = [f"{'expression':16s} {'kernel rel err':>15s} {'torch rel err':>15s} "
             f"{'bits differ':>11s} (of {x.numel()})"]
    for i, name in enumerate(NAMES):
        nd = int((k[i].view(torch.int32) != p[i].view(torch.int32)).sum())
        lines.append(f"{name:16s} {float(ek[i].max()):15.3e} "
                     f"{float(ep[i].max()):15.3e} {nd:11d}")
    return lines
