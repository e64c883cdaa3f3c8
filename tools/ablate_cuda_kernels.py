"""The P2G ablation probe on one NVIDIA GPU: the stages of one P2G pass on
the TPU probe's synthetic jobs, for both node-side cores.

    python3 tools/ablate_cuda_kernels.py

The H100 counterpart of tools/ablate_kernels.py: the same inputs (numpy
default_rng(0); 1,002,001 particles in 1300 live jobs of 1536 slots,
group 1024, 4 x 8 x 4 blocks, h = 1), built by
wgsparkl_tpu_torch.ops.ablation.probe_inputs, and the stages load,
weights, accumulate and full of csrc/p2g_ablation.cu for the scan core
(the node loop of kernels A and F before their redesign), the lists core
(their per-node particle lists, one thread per node) and the pairs core
(the same lists, one thread per two z-neighbour nodes).  Prints the card's
name and power limit, each stage's ms per launch (CUDA events) and checks
each core's full stage against its plain version bit for bit.  Fails
without a CUDA device.
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
    from wgsparkl_tpu_torch.ops import ablation

    inputs = ablation.probe_inputs(device=torch.device("cuda", 0))
    lines, _ = ablation.stage_table(inputs)
    for line in lines:
        print(line)


if __name__ == "__main__":
    main()
