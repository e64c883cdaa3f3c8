"""Drucker-Prager plastic return map, channel form (port of
wgsparkl_tpu/models/drucker_prager.py: DruckerPrager,
drucker_prager_arrays, drucker_prager_project_ch and _ch2).

Disabled plasticity: lambda <= 0 is the "no plasticity" sentinel (the
reference encodes it as lambda = -1), exactly as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch

from wgsparkl_tpu_torch.math import div
from wgsparkl_tpu_torch.math.svd import svd2x2_ch, svd3x3_ch
from wgsparkl_tpu_torch.models.elasticity import lame_lambda_mu


@dataclasses.dataclass(frozen=True)
class DruckerPrager:
    h0: float = float(np.radians(35.0))
    h1: float = float(np.radians(9.0))
    h2: float = 0.2
    h3: float = float(np.radians(10.0))
    lam: float = -1.0
    mu: float = -1.0

    @staticmethod
    def new(young_modulus: float, poisson_ratio: float) -> "DruckerPrager":
        if young_modulus > 0.0:
            lam, mu = lame_lambda_mu(young_modulus, poisson_ratio)
        else:
            lam, mu = -1.0, -1.0
        return DruckerPrager(lam=float(lam), mu=float(mu))


def drucker_prager_arrays(plasticities):
    def col(attr):
        return np.asarray([getattr(p, attr) for p in plasticities], np.float32)

    return {k: col(k) for k in ("h0", "h1", "h2", "h3", "lam", "mu")}


# jnp.sqrt(2.0 / 3.0) in the JAX code: an f32 sqrt of the f32-rounded ratio.
_SQRT_2_3 = float(np.sqrt(np.float32(2.0 / 3.0)))


def _alpha(h0, h1, h2, h3, q):
    angle = h0 + (h1 * q - h3) * torch.exp(-h2 * q)
    s = torch.sin(angle)
    return _SQRT_2_3 * (2.0 * s) / (3.0 - s)


def _sum(xs):
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc


def _prod(xs):
    acc = xs[0]
    for x in xs[1:]:
        acc = acc * x
    return acc


def drucker_prager_project_ch(params, state, fc):
    """fc: dict (i, j) -> [N] of a 3x3 F.  Returns (new_state, new fc)."""
    return _project(params, state, fc, svd3x3_ch(fc))


def drucker_prager_project_ch2(params, state, fc):
    """2D twin of drucker_prager_project_ch (closed-form 2x2 SVD)."""
    return _project(params, state, fc, svd2x2_ch(fc))


def _project(params, state, fc, svd):
    lam, mu = params["lam"], params["mu"]
    enabled = lam > 0.0
    uc, sig, vc = svd
    dim = len(sig)
    df = float(dim)
    alpha = _alpha(params["h0"], params["h1"], params["h2"], params["h3"],
                   state["hardening"])
    strain = [torch.log(torch.clamp(s, min=1e-12)) + div(state["log_vol_gain"], df)
              for s in sig]
    trace = _sum(strain)
    dev = [s - div(trace, df) for s in strain]
    dev_norm = torch.sqrt(_sum([d * d for d in dev]))
    case_a = (trace > 0.0) | (dev_norm == 0.0)
    hard_a = torch.sqrt(_sum([s * s for s in strain]))
    gamma = dev_norm + (df * lam + 2.0 * mu) / (2.0 * mu) * trace * alpha
    case_b = (~case_a) & (gamma <= 0.0)
    scale = gamma / torch.clamp(dev_norm, min=1e-20)
    sig_c = [torch.exp(s - d * scale) for s, d in zip(strain, dev)]
    new_sig = [torch.where(case_a, 1.0, s) for s in sig_c]
    plastic_hardening = torch.where(case_a, hard_a, gamma)
    prev_det = _prod(sig)
    new_det = _prod(new_sig)
    apply = enabled & ~case_b
    out_state = {
        "det": torch.where(
            apply,
            state["det"] * prev_det / torch.where(new_det != 0, new_det, 1.0),
            state["det"]),
        "hardening": torch.where(apply, state["hardening"] + plastic_hardening,
                                 state["hardening"]),
        "log_vol_gain": torch.where(
            apply,
            state["log_vol_gain"]
            + torch.log(torch.clamp(prev_det, min=1e-20))
            - torch.log(torch.clamp(new_det, min=1e-20)),
            state["log_vol_gain"]),
    }
    new_fc = {}
    for i in range(dim):
        for j in range(dim):
            proj = uc[0][i] * new_sig[0] * vc[0][j]
            for m in range(1, dim):
                proj = proj + uc[m][i] * new_sig[m] * vc[m][j]
            new_fc[(i, j)] = torch.where(apply, proj, fc[(i, j)])
    return out_state, new_fc
