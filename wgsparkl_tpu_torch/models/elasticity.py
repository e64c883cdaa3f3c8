"""Corotated and neo-Hookean elastic stress (port of
wgsparkl_tpu/models/elasticity.py: lame_lambda_mu, ElasticCoefficients,
elastic_arrays, the channel forms kirchoff_stress_corotated_ch / _ch2 and
kirchoff_stress_neo_hookean_ch / _ch2, and the matrix forms
kirchoff_stress_corotated / kirchoff_stress_neo_hookean on [..., d, d]
tensors, which go through the channel forms)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wgsparkl_tpu_torch.math.svd import det3_ch, svd2x2_ch, svd3x3_ch


def lame_lambda_mu(young_modulus, poisson_ratio):
    lam = (young_modulus * poisson_ratio
           / ((1.0 + poisson_ratio) * (1.0 - 2.0 * poisson_ratio)))
    mu = young_modulus / (2.0 * (1.0 + poisson_ratio))
    return lam, mu


@dataclasses.dataclass(frozen=True)
class ElasticCoefficients:
    lam: float
    mu: float

    @staticmethod
    def from_young_modulus(young_modulus: float, poisson_ratio: float):
        lam, mu = lame_lambda_mu(young_modulus, poisson_ratio)
        return ElasticCoefficients(lam=float(lam), mu=float(mu))


def _corotated(lam, mu, fc, uc, sig, vc):
    d = len(sig)
    j = sig[0] * sig[1]
    for m in range(2, d):
        j = j * sig[m]
    diag = lam * (j - 1.0) * j
    two_mu = 2.0 * mu
    out = {}
    for i in range(d):
        for jj in range(d):
            acc = None
            for k in range(d):
                shifted = uc[0][i] * (sig[0] - 1.0) * vc[0][k]
                for m in range(1, d):
                    shifted = shifted + uc[m][i] * (sig[m] - 1.0) * vc[m][k]
                term = shifted * fc[(jj, k)]
                acc = term if acc is None else acc + term
            out[(i, jj)] = two_mu * acc + diag if i == jj else two_mu * acc
    return out


def kirchoff_stress_corotated_ch(lam, mu, fc):
    """tau = 2 mu U diag(S - 1) V^T F^T + lam J (J - 1) I on [N] channels."""
    return _corotated(lam, mu, fc, *svd3x3_ch(fc))


def kirchoff_stress_corotated_ch2(lam, mu, fc):
    """2D twin of kirchoff_stress_corotated_ch (closed-form 2x2 SVD)."""
    return _corotated(lam, mu, fc, *svd2x2_ch(fc))


def _neo_hookean(lam, mu, fc, d, det):
    diag = lam * torch.log(torch.clamp(det, min=1e-10)) - mu
    out = {}
    for i in range(d):
        for jj in range(d):
            fft = fc[(i, 0)] * fc[(jj, 0)]
            for k in range(1, d):
                fft = fft + fc[(i, k)] * fc[(jj, k)]
            out[(i, jj)] = mu * fft + diag if i == jj else mu * fft
    return out


def kirchoff_stress_neo_hookean_ch(lam, mu, fc):
    """tau = mu F F^T + (lam log J - mu) I on [N] channels, J = det F
    clamped below at 1e-10."""
    return _neo_hookean(lam, mu, fc, 3, det3_ch(fc))


def kirchoff_stress_neo_hookean_ch2(lam, mu, fc):
    """2D twin of kirchoff_stress_neo_hookean_ch."""
    return _neo_hookean(lam, mu, fc, 2,
                        fc[(0, 0)] * fc[(1, 1)] - fc[(0, 1)] * fc[(1, 0)])


def channels(m):
    """[..., d, d] tensor -> dict (i, j) -> [...] channel of its entries."""
    d = m.shape[-1]
    return {(i, j): m[..., i, j] for i in range(d) for j in range(d)}


def matrix(fc, d: int):
    """dict (i, j) -> [...] channels -> [..., d, d] tensor."""
    return torch.stack([torch.stack([fc[(i, j)] for j in range(d)], -1)
                        for i in range(d)], -2)


def kirchoff_stress_corotated(lam, mu, def_grad):
    """Corotated Kirchhoff stress of [..., d, d] deformation gradients
    (d = 2 or 3; lam, mu [...]): 2 mu U diag(S - 1) V^T F^T + lam J (J - 1) I."""
    d = def_grad.shape[-1]
    ch = kirchoff_stress_corotated_ch if d == 3 else kirchoff_stress_corotated_ch2
    return matrix(ch(lam, mu, channels(def_grad)), d)


def kirchoff_stress_neo_hookean(lam, mu, def_grad):
    """Neo-Hookean Kirchhoff stress of [..., d, d] deformation gradients:
    mu F F^T + (lam log J - mu) I, J = det F clamped below at 1e-10."""
    d = def_grad.shape[-1]
    ch = kirchoff_stress_neo_hookean_ch if d == 3 else kirchoff_stress_neo_hookean_ch2
    return matrix(ch(lam, mu, channels(def_grad)), d)


def elastic_arrays(models):
    """(lam, mu) f32 arrays of a list of ElasticCoefficients."""
    lam = np.asarray([m.lam for m in models], dtype=np.float32)
    mu = np.asarray([m.mu for m in models], dtype=np.float32)
    return lam, mu
