"""Small versions of the cells' scenes for the CPU tests: the
configurations' cell widths, materials and colliders, fewer particles and a
smaller heightfield; and two small scenes with a kinematic body, for which
no cell exists yet: the 3D main path's sand in five walls with the spinning
paddle, shrunk, and a 2D sand block on a spinning stirrer."""

import copy

from mpmbench import run


def small_files(workload: str, episode: int = 4):
    """(cell, configuration, traffic, limits) of a small version of the
    cell: a 32 x 32 block lowered onto the first blade's tip, or an 6 x 8 x 6 block over
    a 24 x 24 field 16 m wide; the cell's traffic with `episode` frames."""
    bench = run.load_benchmark()
    cell, config, traffic, limits = run.cell_files(bench, workload)
    cfg = copy.deepcopy(config)
    if cfg["dim"] == 2:
        cfg["lattice"]["counts"] = [32, 32]
        cfg["lattice"]["origin"][0] = 14.0 - 1.6
        # Lowered onto the blade's tip: contact from the first frame.
        traffic = dict(traffic, lattice_bottom=traffic["lattice_bottom"] - 0.5)
    else:
        cfg["lattice"]["counts"] = [6, 8, 6]
        cfg["lattice"]["origin"] = [-1.5, 0.0, -1.5]
        field = cfg["colliders"][0]
        field["resolution"], field["scale"] = [24, 24], [16.0, 8.0, 16.0]
        cfg["grid_bounds"] = [[-8.0, -6.0, -8.0], [8.0, 12.0, 8.0]]
    return cell, cfg, dict(traffic, episode_frames=episode), limits


SAND = {"density": 2700.0, "radius_cells": 0.25, "young_modulus": 2.0e9,
        "poisson_ratio": 0.2, "phase": 0.0, "max_stretch": -1.0,
        "plasticity": {"young_modulus": 2.0e9, "poisson_ratio": 0.2, "h0_deg": 35.0,
                       "h1_deg": 9.0, "h2": 0.2, "h3_deg": 10.0}}


def _cuboid(he, at, **body):
    return {"kind": "cuboid", "half_extents": list(he), "translation": list(at), **body}


# hf3.frame20's limits and a body_gap limit set from this module's scenes
# on the CPU (seeds 2**31 + 977, 2**31 + 4242, 11, 3,000,000,000): the
# program read body_gap 5.3e-8 to 1.3e-7, the bfloat16 control 6.9e-4 to
# 2.8e-3, the bodies held 0.0158 to 0.0167; 1e-5 lies near the geometric
# mean of the program's largest and the control's smallest.
MOVING_LIMITS = {"start_gap": 1e-4, "pos_gap": 2e-3, "vel_gap": 7e-5, "F_gap": 4e-3,
                 "affine_gap": 7e-3, "dps_gap": 8e-3, "aff_flips": 40, "body_gap": 1e-5}


def moving_files(name: str, episode: int = 4):
    """(cell, configuration, traffic, limits) of a small scene with a
    kinematic body, in contact from the first frame.

    paddle3: upstream sand3's scene (wgsparkl_tpu_torch.scenes.sand_box_3d)
    shrunk: a 15 x 6 x 15 sand block (1,350 particles) half a cell inside
    four walls and 0.4 m over the paddle (half extents 0.5, 1, 3.5, tilted
    -0.5 rad about z, spinning at 1 rad/s about -y), by 8, group 1024: the
    gathered-hybrid mode, the paddle merged in kernels A and B.
    stirrer2: a 24 x 16 sand block (384 particles) 0.1 m over a stirrer
    (half extents 0.6, 0.08, at 0.3 rad, spinning at 1 rad/s) above a fixed
    floor: the 2D dense mode of a moving collider."""
    if name == "paddle3":
        cfg = {"name": name, "dim": 3, "cell_width": 1.0, "substeps": 20,
               "frame_rate": 60.0, "gravity": [0.0, -9.81, 0.0],
               "lattice": {"counts": [15, 6, 15], "per_cell": 2,
                           "origin": [-3.75, 0.0, -3.75]},
               "material": SAND,
               "colliders": [
                   _cuboid((8.0, 2.0, 8.0), (0.0, -2.0, 0.0)),
                   _cuboid((4.5, 2.5, 0.5), (0.0, 2.5, -4.5)),
                   _cuboid((4.5, 2.5, 0.5), (0.0, 2.5, 4.5)),
                   _cuboid((0.5, 2.5, 4.5), (-4.5, 2.5, 0.0)),
                   _cuboid((0.5, 2.5, 4.5), (4.5, 2.5, 0.0)),
                   _cuboid((0.5, 1.0, 3.5), (0.0, 1.0, 0.0), rotation=[0.0, 0.0, -0.5],
                           body_type="kinematic", angvel=[0.0, -1.0, 0.0])],
               "grid_bounds": [[-7.0, -2.0, -7.0], [7.0, 8.0, 7.0]],
               "transfer": "pallas", "group": 1024, "by": 8}
        bottom = 2.25
    else:
        cfg = {"name": name, "dim": 2, "cell_width": 0.2, "substeps": 10,
               "frame_rate": 60.0, "gravity": [0.0, -9.81],
               "lattice": {"counts": [24, 16], "per_cell": 2, "origin": [-1.2, 0.0]},
               "material": dict(SAND, density=1000.0, young_modulus=1.0e7,
                                plasticity=dict(SAND["plasticity"], young_modulus=1.0e7)),
               "colliders": [
                   _cuboid((3.0, 0.2), (0.0, -0.2)),
                   _cuboid((0.6, 0.08), (0.0, 0.5), rotation=0.3, body_type="kinematic",
                           angvel=1.0)],
               "grid_bounds": [[-3.0, -0.6], [3.0, 3.0]],
               "transfer": "pallas", "group": 256, "by": 4}
        bottom = 0.8
    traffic = {"name": f"{name}_contact", "entry": "MpmPipeline.step",
               "substeps_per_call": cfg["substeps"], "episode_frames": episode,
               "lattice_bottom": bottom, "jitter": 0.1}
    cell = {"name": f"{name}.test", "config": name, "traffic": traffic["name"], "chips": 1}
    return cell, cfg, traffic, dict(MOVING_LIMITS)
