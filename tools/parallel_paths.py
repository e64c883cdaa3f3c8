"""Paths 15-15d of chip_smoke.py alone: multi-device stepping at full size.

    python3 tools/parallel_paths.py

Builds the kernels, then runs `chip_smoke.parallel_paths`: the main scene
particle-sharded over 4 ranks (path 15), in 4 x slabs (15b), the 2D column
in 2 slabs (15c) and path 12 in 4 slabs (15d), each first with the ranks
sharing cuda:0 through gloo (host-staged) and, on a host with a card a
rank, again on NCCL with one card a rank; the same gates as chip_smoke.py.
Fails (non-zero) without a CUDA device or where a gate fails.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("FAIL: torch.cuda.is_available() is False")
    import wgsparkl_tpu_torch as wt
    from wgsparkl_tpu_torch import _cuda

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"cards ({torch.cuda.device_count()}): {card}", flush=True)
    t0 = time.time()
    _cuda.build(_cuda.sources())
    print(f"built in {time.time() - t0:.1f} s", flush=True)
    chip_smoke.parallel_paths(wt, card.splitlines()[0], torch.cuda.get_device_name(0),
                              {}, {})
    print(f"paths 15-15d passed in {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
