"""Small versions of the cells' scenes for the CPU tests: the
configurations' cell widths, materials and colliders, fewer particles and a
smaller heightfield."""

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
