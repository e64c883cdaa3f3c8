"""Where the port's state lives: on the card unless the caller asks for the
CPU (the tests do, with device="cpu")."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The device a constructor or entry point builds on: None means cuda:0.
    Asking for a CUDA device where torch sees none raises; the port never
    falls back to the CPU by itself."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch sees no CUDA device "
            "(pass device='cpu' to run on the CPU)")
    return dev
