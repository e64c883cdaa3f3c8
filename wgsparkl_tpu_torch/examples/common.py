"""Shared runner of the examples: build a scene, run Testbed frames, print
the stats as JSON and require finite positions.

The runner runs on the card; DEVICE=cpu asks for the CPU (nothing falls back
to it).  TRANSFER picks the transfer (pallas by default, the path the
examples show first; dense or blocked to compare), GROUP the job size,
FRAMES the frame count, PLY_EVERY a point-cloud dump every that many
frames into DUMP_DIR.
"""

from __future__ import annotations

import json
import os
import tempfile


def device():
    """The runner's device: DEVICE from the environment, else the card."""
    return os.environ.get("DEVICE") or None


def scale(default: float) -> float:
    return float(os.environ.get("SCALE", default))


def transfer_kw(transfer: str = "pallas", group: int = 256):
    """MpmData keyword arguments of a transfer: the job size `group` goes
    with the blocked and pallas transfers only, as the JAX examples pass
    it."""
    return {"transfer": transfer,
            **({"group": group} if transfer in ("blocked", "pallas") else {})}


def env_kw(*names: str):
    """The build keyword arguments set in the environment: TRANSFER and
    GROUP, and any of `names` (such as "BY"), each only where it is set."""
    kw = {}
    if "TRANSFER" in os.environ:
        kw["transfer"] = os.environ["TRANSFER"]
    for var in ("GROUP", *names):
        if var in os.environ:
            kw[var.lower()] = int(os.environ[var])
    return kw


def run_example(data, num_substeps, frames=120, name=""):
    """Run `frames` frames (FRAMES overrides) through the Testbed and print
    its stats; returns the Testbed."""
    from wgsparkl_tpu_torch.testbed import Testbed

    tb = Testbed(data, num_substeps=num_substeps)
    every = int(os.environ.get("PLY_EVERY", 0)) or None
    dump_dir = os.environ.get("DUMP_DIR") or os.path.join(
        tempfile.gettempdir(), f"wgsparkl_frames_{name or 'scene'}")
    stats = tb.run(int(os.environ.get("FRAMES", frames)), dump_ply_every=every,
                   dump_dir=dump_dir)
    print(json.dumps({"example": name, **stats}, indent=2))
    if not stats["finite"]:
        raise RuntimeError("simulation produced non-finite state")
    return tb
