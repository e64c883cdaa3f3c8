"""The JAX package's particle-sharded step in the sparse domain, against its
own single-device step, on the CPU.

    python3 tools/check_jax_sparse_sharding.py

Runs tests/test_parallel.py's `_spatial_scene` (a 24 x 8 x 8 elastic
lattice with lateral velocities over a floor) built sparse, 3 substeps,
once on one virtual CPU device and once particle-sharded over two with
`make_sharded_step` (no spatial_config): each shard builds its own slot
table, and the sum of the two slot grids adds unrelated blocks where the
tables differ.  Prints the largest position and velocity differences by
particle id.  The port refuses this mode (parallel/domain.make_sharded_step
raises ValueError); the spatial decomposition is the sparse domain's
multi-device mode in both packages.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import test_parallel as tp  # noqa: E402
from wgsparkl_tpu.parallel import make_sharded_step, shard_state  # noqa: E402
from wgsparkl_tpu.pipeline import MpmData, step_pallas  # noqa: E402


def main() -> None:
    particles, models, bodies, params, grid = tp._spatial_scene()
    data = MpmData(params, particles, models, bodies, 1.0, grid=grid,
                   transfer="pallas", group=64, job_chunk=8, sparse=True)
    ref = jax.jit(lambda s, p: step_pallas(s, p, data.config, 3))(data.state, data.params)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("dp",))
    out = make_sharded_step(data.config, mesh, 3)(shard_state(data.state, mesh),
                                                  data.params)
    io = np.argsort(np.asarray(out.particles.ids))
    ir = np.argsort(np.asarray(ref.particles.ids))
    for name in ("pos", "vel"):
        a = np.asarray(getattr(out.particles, name))[io]
        b = np.asarray(getattr(ref.particles, name))[ir]
        print(f"{name}: max |sharded - single device| {np.abs(a - b).max():.6g} "
              f"({data.num_particles} particles, 2 shards, 3 substeps)")


if __name__ == "__main__":
    main()
