"""The in-kernel math probe's plain version (wgsparkl_tpu_torch.math.probe)
against the TPU probe's Pallas `kernel` (tools/probe_mosaic_math.py, loaded
by path and run in interpret mode on the CPU) on the same inputs, within
2 ulps, and its log row against float64.

XLA:CPU and torch's CPU code round the Newton forms and sqrt differently in
a few hundred of the 4096 elements (contracted multiply-adds), by 1-2 ulps.
exp(log(x) / 2) is held within 4 ulps: the two back ends' log(x) differ by
an ulp in 201 elements, and at |log x| up to 8 that ulp of exp's argument
is up to 2 ulps of its value, besides each exp's own rounding."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from wgsparkl_tpu_torch.math import probe

_TOOL = pathlib.Path(__file__).resolve().parent.parent / "tools" / "probe_mosaic_math.py"
ULP2 = 2 * 2.0 ** -23


def _ulps(a, ref):
    return np.abs(a.astype(np.float64) - ref) / np.spacing(np.abs(ref).astype(np.float32))


def _tpu_probe_kernel():
    spec = importlib.util.spec_from_file_location("probe_mosaic_math", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.kernel


@pytest.fixture(scope="module")
def outputs():
    x, y = probe.probe_inputs("cpu")
    out = probe.math_probe(x, y).numpy()
    run = pl.pallas_call(_tpu_probe_kernel(),
                         out_shape=jax.ShapeDtypeStruct((8,) + tuple(x.shape),
                                                        jnp.float32),
                         interpret=True)
    # JAX gets copies: it may alias a host buffer it is handed.
    ref = np.asarray(jax.jit(run)(x.numpy().copy(), y.numpy().copy()))
    return x, y, out, ref


def test_probe_inputs_are_the_tpu_probes():
    x, y = probe.probe_inputs("cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        x.numpy(), np.float32(np.exp(rng.uniform(-8, 8, size=(8, 512)))))
    np.testing.assert_array_equal(
        y.numpy(), np.float32(np.exp(rng.uniform(-4, 4, size=(8, 512)))))


@pytest.mark.parametrize("k", range(8), ids=probe.NAMES[:8])
def test_probe_plain_matches_tpu_probe_kernel(outputs, k):
    x, y, out, ref = outputs
    f64 = probe.float64_reference(x, y).numpy()[k]
    assert _ulps(out[k], ref[k]).max() <= (4 if probe.NAMES[k] == "exp_log_sqrt" else 2), (
        _ulps(out[k], f64).max(), _ulps(ref[k], f64).max())


def test_probe_log_row_against_float64(outputs):
    x, y, out, _ = outputs
    assert out.shape == (len(probe.NAMES),) + tuple(x.shape)
    ref = probe.float64_reference(x, y).numpy()
    rel = np.abs(out[8] - ref[8]) / np.abs(ref[8])
    assert rel.max() <= ULP2
