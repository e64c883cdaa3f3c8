"""The one-cell-per-substep velocity limit cell_width / dt at each of the
port's five sites, against the JAX package's f32 division
grid.cell_width / params.dt, at cell widths and substep counts where an
f64 division rounded once to f32 gives another value (0.2 at 16 substeps:
191.99998 against 192.0; at 32: 383.99997 against 384.0)."""

import numpy as np
import pytest
import torch

from wgsparkl_tpu.grid import GridConfig as JGridConfig
from wgsparkl_tpu.ops.particle_update import particle_update_channels as j_update
from wgsparkl_tpu.params import SimulationParams as JParams
from wgsparkl_tpu_torch import pipeline
from wgsparkl_tpu_torch.grid import GridConfig
from wgsparkl_tpu_torch.models.drucker_prager import (
    DruckerPrager, drucker_prager_arrays,
)
from wgsparkl_tpu_torch.ops.particle_update import particle_update_channels
from wgsparkl_tpu_torch.ops.update_rows import kernel_scalars
from wgsparkl_tpu_torch.params import SimulationParams
from wgsparkl_tpu_torch.solver import DPS_KEYS


# Speeds around the limit: three above it (one per axis direction) and one
# below.
_VEL = np.array([[1000.0, 0.0, 0.0], [0.0, -500.0, 0.0], [300.0, 400.0, 20.0],
                 [1.0, 0.0, 0.0]], np.float32).T


def _jax_limit(h, substeps):
    params = JParams.new((1.0 / 60.0) / substeps, [0.0, -9.81, 0.0])
    return np.float32(JGridConfig((8, 8, 8), h, (0, 0, 0)).cell_width / params.dt)


def _update_channels(lib):
    """Channels of four particles at rest in F = I with plasticity off."""
    n = _VEL.shape[1]
    full = lambda v: lib(np.full(n, v, np.float32))  # noqa: E731
    dp = drucker_prager_arrays([DruckerPrager.new(1.0e7, 0.2)])
    return {
        "pos": [full(0.0)] * 3, "vel": [lib(_VEL[a].copy()) for a in range(3)],
        "grad": {(i, j): full(0.0) for i in range(3) for j in range(3)},
        "F": {(i, j): full(float(i == j)) for i in range(3) for j in range(3)},
        "sd": full(0.0), "normal": [full(0.0)] * 3, "rigid_vel": [full(0.0)] * 3,
        "mass": full(1.0), "vol0": full(1.0), "lam": full(1.0e6),
        "mu": full(1.0e6), "dp": {k: full(-1.0 if k == "lam" else float(v[0]))
                                  for k, v in dp.items()},
        "dps": {k: full(1.0 if k != "log_vol_gain" else 0.0) for k in DPS_KEYS},
        "phase": full(1.0), "stretch": full(-1.0),
    }


def _port_site(site, h, dt):
    """The limit as the port's site uses it (the clamped speed of a
    particle moving at 1000 along x for the particle update)."""
    grid = GridConfig((8, 8, 8) if site != "body_table_2d" else (8, 8), h,
                      (0, 0, 0) if site != "body_table_2d" else (0, 0))
    params = SimulationParams.new(dt, [0.0, -9.81, 0.0][:grid.dim], device="cpu")
    if site in ("body_table_3d", "body_table_2d"):
        dim = grid.dim
        world = pipeline.build_rigid_world([], dim, "cpu")
        row = (24, 3) if dim == 3 else (13, 2)
        return float(pipeline._body_table(world, params, grid)[row])
    if site == "grid_velocity":
        mm = torch.tensor([[1.0e9, -1.0e9, 0.0, 1.0]])
        return float(pipeline._grid_velocity(mm, params, grid)[0, 0])
    if site == "kernel_c":
        return float(kernel_scalars(params.dt, h)[3])
    out = particle_update_channels(_update_channels(torch.as_tensor), params.dt, h)
    return np.stack([v.numpy() for v in out["vel"]])


SITES = ("body_table_3d", "body_table_2d", "grid_velocity", "particle_update",
         "kernel_c")


@pytest.mark.parametrize("h,substeps", [(0.2, 16), (0.2, 32)])
@pytest.mark.parametrize("site", SITES)
def test_velocity_limit_matches_jax(site, h, substeps):
    ref = _jax_limit(h, substeps)
    dt = float(np.float32((1.0 / 60.0) / substeps))
    got = _port_site(site, h, dt)
    if site == "particle_update":
        import jax.numpy as jnp

        jparams = JParams.new((1.0 / 60.0) / substeps, [0.0, -9.81, 0.0])
        out = j_update(_update_channels(jnp.asarray), jparams,
                       JGridConfig((8, 8, 8), h, (0, 0, 0)))
        want = np.stack([np.asarray(v) for v in out["vel"]])
        np.testing.assert_array_equal(got, want)
        # The first three particles were clamped: speed ~ the limit.
        speed = np.sqrt((want[:, :3].astype(np.float64) ** 2).sum(0))
        np.testing.assert_allclose(speed, ref, rtol=1e-6)
        return
    assert np.float32(got) == ref, (got, float(ref))
