"""The in-kernel f32 math of the CUDA kernels against float64 and against
the PyTorch calls of their plain versions, on one NVIDIA GPU.

    python3 tools/probe_cuda_math.py

The H100 counterpart of tools/probe_mosaic_math.py: the same inputs (numpy
default_rng(0), x = exp(U(-8, 8)), y = exp(U(-4, 4)), [8, 512] f32 each)
and the same eight expressions, plus logf(x), computed by
csrc/math_probe.cu, which is built like every kernel of the package
(-fmad=false, IEEE division and sqrt).  For each expression it prints the
kernel's largest relative error against float64, the same for the PyTorch
CUDA calls the plain versions use (1/x, y/x, torch.sqrt, torch.rsqrt,
torch.exp, torch.log), and how many of the 4096 elements differ in bits
between the two.  Fails without a CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("FAIL: torch.cuda.is_available() is False")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} ({card}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    from wgsparkl_tpu_torch.math.probe import probe_table

    for line in probe_table(torch.device("cuda", 0)):
        print(line)


if __name__ == "__main__":
    main()
