"""Headless testbed: the application harness around the pipeline (port of
wgsparkl_tpu/testbed.py).

A frame loop with callbacks, live-adjustable substeps and gravity, per-frame
stats, optional point-cloud dumps and checkpoint / restart.  A frame is
`MpmPipeline.step` of the scene's substeps, synchronised once at its end
(torch.cuda.synchronize on the card), which its wall time covers; the frame's
StepDiag is kept in `diag`.  `params()` is rebuilt only when the gravity
factor changes, so a frame copies nothing from the host to the device.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from wgsparkl_tpu_torch import render
from wgsparkl_tpu_torch.params import SimulationParams
from wgsparkl_tpu_torch.pipeline import MpmData, MpmPipeline
from wgsparkl_tpu_torch.utils import checkpoint


@dataclasses.dataclass
class RunState:
    running: bool = True
    num_substeps: int = 0          # 0 = use the scene default
    gravity_factor: float = 1.0
    render_mode: str = "default"


class SceneInits:
    """Scene registry: name -> constructor of an MpmData."""

    def __init__(self, scenes: Dict[str, Callable[[], MpmData]]):
        self.scenes = dict(scenes)

    def names(self):
        return list(self.scenes)

    def build(self, name: str) -> MpmData:
        return self.scenes[name]()


class Testbed:
    def __init__(self, data: MpmData, num_substeps: int,
                 on_frame: Optional[Callable] = None):
        self.data = data
        self.run_state = RunState(num_substeps=num_substeps)
        self.on_frame = on_frame
        self.frame = 0
        self.frame_ms: list[float] = []
        self.pipeline = MpmPipeline()
        self.diag = None
        self._params = (None, None)     # (gravity factor, params)

    def params(self) -> SimulationParams:
        """The scene's parameters with gravity scaled by the run state's
        factor; rebuilt only when the factor changes."""
        gf = self.run_state.gravity_factor
        if self._params[0] != gf:
            base = self.data.params
            self._params = (gf, SimulationParams(dt=base.dt, gravity=base.gravity * gf))
        return self._params[1]

    def step_frame(self):
        """One frame of num_substeps substeps, synchronised at its end."""
        if not self.run_state.running:
            return
        t0 = time.perf_counter()
        self.diag = self.pipeline.step(self.data, self.run_state.num_substeps,
                                       self.params())
        if self.data.state.particles.pos.device.type == "cuda":
            torch.cuda.synchronize()
        self.frame_ms.append((time.perf_counter() - t0) * 1e3)
        self.frame += 1
        if self.on_frame is not None:
            self.on_frame(self)

    def run(self, frames: int, dump_ply_every: Optional[int] = None,
            dump_dir: Optional[str] = None):
        """`frames` frames; every dump_ply_every-th frame a PLY of the
        particles and the colliders' surfaces (in grey) into dump_dir (a
        directory under the temporary directory by default)."""
        dump_dir = dump_dir or os.path.join(tempfile.gettempdir(), "wgsparkl_frames")
        if dump_ply_every:
            os.makedirs(dump_dir, exist_ok=True)
        for _ in range(frames):
            self.step_frame()
            if dump_ply_every and self.frame % dump_ply_every == 0:
                self.write_frame(f"{dump_dir}/frame_{self.frame:05d}.ply")
        return self.stats()

    def write_frame(self, path: str):
        """The current particles, coloured in the run state's render mode,
        and the colliders' surface points at their current poses, as one
        PLY (at most 200,000 particles)."""
        cell_width = self.data.config.grid.cell_width
        inst = render.prep_instances(self.data.state.particles,
                                     mode=render.MODES[self.run_state.render_mode],
                                     cell_width=cell_width)
        bodies = self.data.state.bodies
        cpts = render.collider_surface_points(self.data.bodies_desc, bodies.rot,
                                              bodies.pos, spacing=0.7 * cell_width)
        if len(cpts):
            inst = {"position": np.concatenate([render.as_numpy(inst["position"]), cpts]),
                    "color": np.concatenate([render.as_numpy(inst["color"]),
                                             np.full((len(cpts), 3), 0.55, np.float32)])}
        render.write_ply(path, inst, max_points=200_000 + len(cpts))

    def stats(self) -> dict:
        p = self.data.state.particles.pos.cpu().numpy()
        ms = np.asarray(self.frame_ms[1:] or self.frame_ms)
        return {
            "frames": self.frame,
            "particles": self.data.num_particles,
            "frame_ms_mean": float(ms.mean()) if len(ms) else None,
            "steps_per_s": (1e3 / ms.mean() * self.run_state.num_substeps
                            if len(ms) else None),
            "pos_min": p.min(0).tolist(),
            "pos_max": p.max(0).tolist(),
            "finite": bool(np.isfinite(p).all()),
        }

    def save_checkpoint(self, path: str):
        checkpoint.save(path, self.data.state,
                        extra={"frame": self.frame,
                               "substeps": self.run_state.num_substeps})

    def load_checkpoint(self, path: str):
        self.data.state, extra = checkpoint.load(path, self.data.state)
        self.frame = int(extra.get("frame", 0))
