"""The neo-Hookean branch of the PyTorch port (the stress, the plain kernel
C in 3D and 2D, and whole slices) against the JAX package.

Tolerance of `log`: XLA:CPU's and torch's CPU logf may differ by an ulp,
and the stress carries lambda log J.  With lambda up to 5.6e8 (the sand
box) an ulp of log J near 1 moves the stress by ~1e-7 of its own scale,
so the stress is held to 1e-6 relative to the largest entry, and the
affine rows of kernel C to a few ulps of the moduli."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from wgsparkl_tpu.models import elasticity as jel
from wgsparkl_tpu.ops.kernel import inv_d
from wgsparkl_tpu.ops.update_rows import update_rows as j_update_rows
from wgsparkl_tpu.pipeline import step_pallas as j_step
from wgsparkl_tpu import scenes as jscenes
from wgsparkl_tpu_torch import interop
from wgsparkl_tpu_torch.models import elasticity as tel
from wgsparkl_tpu_torch.ops import rows as R
from wgsparkl_tpu_torch.ops import rows2d as R2
from wgsparkl_tpu_torch.ops.update_rows import update_plain, update2d_plain
from wgsparkl_tpu_torch.pipeline import step_with_diag

torch.set_num_threads(2)
SUBSTEPS = 10
_j_step = jax.jit(j_step, static_argnums=(2, 3))


@pytest.mark.parametrize("dim", [3, 2])
def test_neo_hookean_stress_matches_jax(dim):
    """mu F F^T + (lam log J - mu) I on deformation gradients near the
    identity and inverted ones (J clamped at 1e-10)."""
    rng = np.random.default_rng(0)
    n = 4096
    f = np.eye(dim, dtype=np.float32) + rng.uniform(-0.3, 0.3, (n, dim, dim))
    f[: n // 8, 0] *= -1.0                      # inverted: det F < 0
    f = f.astype(np.float32)
    lam = rng.uniform(1e5, 5.6e8, n).astype(np.float32)
    mu = rng.uniform(1e5, 8.4e8, n).astype(np.float32)
    fc = {(i, k): f[:, i, k] for i in range(dim) for k in range(dim)}
    jfn = jel.kirchoff_stress_neo_hookean_ch if dim == 3 else jel.kirchoff_stress_neo_hookean_ch2
    tfn = tel.kirchoff_stress_neo_hookean_ch if dim == 3 else tel.kirchoff_stress_neo_hookean_ch2
    ref = jfn(jnp.asarray(lam), jnp.asarray(mu), {k: jnp.asarray(v) for k, v in fc.items()})
    out = tfn(torch.as_tensor(lam), torch.as_tensor(mu),
              {k: torch.as_tensor(v) for k, v in fc.items()})
    scale = max(float(np.abs(np.asarray(v)).max()) for v in ref.values())
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=0,
                                   atol=1e-6 * scale)


def _jax_update(d, data, dim):
    cfg = dataclasses.replace(data.config, elastic_model="neo_hookean")
    nb_total = int(d["grid_mm"].shape[0] - 1)
    return np.asarray(j_update_rows(
        jnp.asarray(d["rows"]), jnp.asarray(d["krows"]), jnp.asarray(d["pcdf"]),
        jnp.asarray(d["sorted_ids"]), int(d["covered_end"]),
        jnp.asarray(d["btable"]), jnp.asarray(d["mtable"]), data.params, cfg,
        cfg.num_colliders, inv_d(cfg.grid.cell_width), live_below=nb_total,
        dim=dim))


@pytest.mark.parametrize("dim", [3, 2])
def test_update_rows_neo_hookean_matches_jax(dim):
    """The plain kernel C with elastic_model="neo_hookean" against the JAX
    update kernel in interpret mode, on one substep's inputs: the sand box
    lowered onto the paddle with its particles made elastic (phase 1: no
    return map, whose SVD roundoff would swamp the stress), and the elastic
    blocks (2D)."""
    if dim == 3:
        data, d = H.jax_dump(H.SHIFTS["on_paddle"])
        L, plain = R, update_plain
        d = dict(d, rows=d["rows"].copy())
        d["rows"][R.R_PHASE] = 1.0
    else:
        data, d = H.jax_dump_2d("elastic_blocks")
        L, plain = R2, update2d_plain
    cfg = data.config
    nb_total = int(d["grid_mm"].shape[0] - 1)
    dt = float(np.float32(data.params.dt))
    args = (H.to_torch(d["rows"]), H.to_torch(d["krows"]), H.to_torch(d["pcdf"]),
            H.to_torch(d["sorted_ids"]), int(d["covered_end"]),
            H.to_torch(d["btable"]), H.to_torch(d["mtable"]), dt,
            cfg.grid.cell_width, cfg.num_colliders, cfg.n_materials, nb_total)
    out = plain(*args, elastic_model="neo_hookean").numpy()
    ref = _jax_update(d, data, dim)
    for r in (L.AFF, L.AFF_SPARE, L.R_IDS, L.R_MID):
        np.testing.assert_array_equal(out[r], ref[r])
    affine = list(range(L.A0, L.A0 + dim * dim))
    rest = [r for r in range(L.PCHAN) if r not in affine]
    np.testing.assert_allclose(out[rest], ref[rest], rtol=1e-5, atol=1e-5)
    # The affine rows carry the stress (terms of the size of the moduli)
    # times V0 D^-1 dt; XLA:CPU contracts its multiply-adds, the port does
    # not, and the two logf may differ by an ulp: 4 ulps of the larger
    # modulus (measured: 1.8 in 3D, 1.2 in 2D).
    mt = d["mtable"]
    scale_a = mt[R.MTAB_VOL, 0] * inv_d(cfg.grid.cell_width) * dt
    tol = 4 * 2.0 ** -23 * max(mt[R.MTAB_LAM, 0], mt[R.MTAB_MU, 0]) * scale_a
    np.testing.assert_allclose(out[affine], ref[affine], rtol=0, atol=tol)
    # The branch is taken: the corotated stress misses by more than that.
    corot = plain(*args).numpy()
    assert np.abs(corot[affine] - ref[affine]).max() > tol


def _neo_scene(dim):
    if dim == 3:
        return jscenes.sand_box_3d(nxz=8, ny=16, cell_width=1.0, transfer="pallas",
                                   group=H.GROUP, job_chunk=8, by=H.BY,
                                   elastic_model="neo_hookean")
    return jscenes.elastic_blocks_2d(n_side=24, cell_width=0.5, transfer="pallas",
                                     group=H.GROUP_2D, elastic_model="neo_hookean")


@pytest.mark.parametrize("dim", [3, 2])
def test_step_pallas_neo_hookean_matches_jax(dim):
    """sand_box_3d(nxz=8, ny=16) with the paddle and elastic_blocks_2d(
    n_side=24), both neo-Hookean, over 10 substeps: positions 1e-5,
    velocities and F 1e-4, affinity words exact, bodies 1e-6."""
    data = _neo_scene(dim)
    cfg = interop.config_from_reference(data.config)
    assert cfg.elastic_model == "neo_hookean"
    ref = _j_step(data.state, data.params, data.config, SUBSTEPS)
    out, diag = step_with_diag(interop.state_from_reference(data.state, "cpu"),
                               interop.params_from_reference(data.params, "cpu"),
                               cfg, SUBSTEPS)
    assert not diag.any_overflow()
    H.compare_states(ref, out)


def test_unknown_elastic_model_raises():
    """The reference config carries corotated and neo-Hookean across; a
    model neither package has raises."""
    j = jscenes.sand_box_3d(nxz=4, ny=6, transfer="pallas", by=8)
    for m in ("corotated", "neo_hookean"):
        cfg = interop.config_from_reference(dataclasses.replace(j.config,
                                                                elastic_model=m))
        assert cfg.elastic_model == m
    with pytest.raises(NotImplementedError, match="elastic_model"):
        interop.config_from_reference(dataclasses.replace(j.config,
                                                          elastic_model="stvk"))
    from wgsparkl_tpu_torch import scenes

    with pytest.raises(ValueError, match="elastic model"):
        scenes.sand_box_3d(nxz=4, ny=6, by=8, device="cpu", elastic_model="stvk")
