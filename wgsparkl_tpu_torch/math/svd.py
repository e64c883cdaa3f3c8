"""Signed 2x2 and 3x3 SVD (port of wgsparkl_tpu/math/svd.py): the channel
forms svd2x2_ch, svd3x3_ch and eig33_sigma_ch, and the matrix forms svd2x2,
svd3x3, svd and recompose over them.

3x3: cyclic Jacobi on F^T F with trig-free Givens rotations, 8 sweeps of
the (0,1), (0,2), (1,2) planes in that order, exactly as the JAX package
does.  2x2: closed-form polar decomposition, then one Givens rotation of
the symmetric factor.  Channels are [N] tensors.  Every JAX rsqrt is an
IEEE divide of a sqrt here, so the plain versions and the CUDA kernels of
ops/update_rows.py agree operation for operation.

Convention: F = U diag(S) V^T with U, V proper rotations, S sorted by
decreasing value, and the last singular value carrying sign(det F).
"""

from __future__ import annotations

import torch


def _givens(app, aqq, apq):
    nonzero = apq.abs() > 1e-30
    safe = torch.where(nonzero, apq, 1.0)
    tau = (app - aqq) / (2.0 * safe)
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(nonzero, t, 0.0)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


def svd2x2_ch(fc):
    """fc: dict (i, j) -> [N] of a 2x2 F.  Returns (uc, sig, vc): uc[k] /
    vc[k] the two channels of the k-th column of U / V, sig = [s0, s1]
    with s0 >= |s1| and sign(s1) = sign(det F)."""
    a, b = fc[(0, 0)], fc[(0, 1)]
    c, d = fc[(1, 0)], fc[(1, 1)]
    det = a * d - b * c
    sgn = torch.where(det < 0.0, -1.0, 1.0)
    # Reflect so that det(B) >= 0: B = F diag(1, sgn).
    b01, b11 = b * sgn, d * sgn
    # Polar rotation R of B: [[x, -y], [y, x]] / hypot(x, y).
    x = a + b11
    y = c - b01
    h2 = x * x + y * y
    ok = h2 > 1e-30
    inv_h = torch.where(ok, 1.0 / torch.sqrt(torch.clamp(h2, min=1e-30)), 0.0)
    cr = torch.where(ok, x * inv_h, 1.0)
    sr = y * inv_h
    # Symmetric factor P = R^T B, diagonalised by V = [[cv, -sv], [sv, cv]].
    p00 = cr * a + sr * c
    p01 = cr * b01 + sr * b11
    p11 = -sr * b01 + cr * b11
    cv, sv = _givens(p00, p11, p01)
    l0 = cv * cv * p00 + 2.0 * cv * sv * p01 + sv * sv * p11
    l1 = sv * sv * p00 - 2.0 * cv * sv * p01 + cv * cv * p11
    # Sort descending; the 90-degree turn keeps V in SO(2).
    swap = l0 < l1
    cv, sv = torch.where(swap, -sv, cv), torch.where(swap, cv, sv)
    s0 = torch.where(swap, l1, l0)
    s1 = torch.where(swap, l0, l1)
    cu = cr * cv - sr * sv
    su = sr * cv + cr * sv
    uc = [[cu, su], [-su, cu]]
    vc = [[cv, sv * sgn], [-sv * sgn, cv]]
    return uc, [s0, s1 * sgn], vc


def _key(i, j):
    return (i, j) if i <= j else (j, i)


def _jacobi_rot(sym, v, p, q):
    r = 3 - p - q
    app, aqq, apq = sym[_key(p, p)], sym[_key(q, q)], sym[_key(p, q)]
    c, s = _givens(app, aqq, apq)
    c2, s2, cs = c * c, s * s, c * s
    new = dict(sym)
    new[_key(p, p)] = c2 * app + 2.0 * cs * apq + s2 * aqq
    new[_key(q, q)] = s2 * app - 2.0 * cs * apq + c2 * aqq
    new[_key(p, q)] = torch.zeros_like(apq)
    apr, aqr = sym[_key(p, r)], sym[_key(q, r)]
    new[_key(p, r)] = c * apr + s * aqr
    new[_key(q, r)] = -s * apr + c * aqr
    if v is None:
        return new, None
    vnew = dict(v)
    for i in range(3):
        vip, viq = v[(i, p)], v[(i, q)]
        vnew[(i, p)] = c * vip + s * viq
        vnew[(i, q)] = -s * vip + c * viq
    return new, vnew


def _sym_ftf(fc):
    sym = {}
    for i in range(3):
        for j in range(i, 3):
            acc = fc[(0, i)] * fc[(0, j)]
            for k in range(1, 3):
                acc = acc + fc[(k, i)] * fc[(k, j)]
            sym[(i, j)] = acc
    return sym


def _norm3(x, y, z):
    return torch.sqrt(x * x + y * y + z * z)


def svd3x3_ch(fc, sweeps: int = 8):
    """fc: dict (i, j) -> [N].  Returns (uc, sig, vc): uc[k]/vc[k] are the
    three channels of the k-th column of U/V; sig the three singular values."""
    sym = _sym_ftf(fc)
    zero = torch.zeros_like(fc[(0, 0)])
    one = torch.ones_like(zero)
    v = {(i, j): (one if i == j else zero) for i in range(3) for j in range(3)}
    for _ in range(sweeps):
        sym, v = _jacobi_rot(sym, v, 0, 1)
        sym, v = _jacobi_rot(sym, v, 0, 2)
        sym, v = _jacobi_rot(sym, v, 1, 2)
    lam = [sym[(0, 0)], sym[(1, 1)], sym[(2, 2)]]
    vcols = [[v[(i, k)] for i in range(3)] for k in range(3)]

    def cswap(a, b):
        la, ca = a
        lb, cb = b
        swap = la < lb
        na = (torch.where(swap, lb, la),
              [torch.where(swap, y, x) for x, y in zip(ca, cb)])
        nb = (torch.where(swap, la, lb),
              [torch.where(swap, x, y) for x, y in zip(ca, cb)])
        return na, nb

    e0, e1, e2 = (lam[0], vcols[0]), (lam[1], vcols[1]), (lam[2], vcols[2])
    e0, e1 = cswap(e0, e1)
    e0, e2 = cswap(e0, e2)
    e1, e2 = cswap(e1, e2)
    lam = [e0[0], e1[0], e2[0]]
    vc = [e0[1], e1[1], e2[1]]
    v2 = [
        vc[0][1] * vc[1][2] - vc[0][2] * vc[1][1],
        vc[0][2] * vc[1][0] - vc[0][0] * vc[1][2],
        vc[0][0] * vc[1][1] - vc[0][1] * vc[1][0],
    ]
    vc = [vc[0], vc[1], v2]
    sig = [torch.sqrt(torch.clamp(lv, min=0.0)) for lv in lam]

    def matvec(cols):
        out = []
        for i in range(3):
            acc = fc[(i, 0)] * cols[0]
            for k in range(1, 3):
                acc = acc + fc[(i, k)] * cols[k]
            out.append(acc)
        return out

    def normalize(u, fallback):
        n = _norm3(*u)
        ok = n > 1e-12
        inv = torch.where(ok, 1.0 / torch.where(ok, n, 1.0), 0.0)
        return [torch.where(ok, x * inv, fb) for x, fb in zip(u, fallback)]

    fv0 = matvec(vc[0])
    fv1 = matvec(vc[1])
    u0 = normalize(fv0, [one, zero, zero])
    d01 = fv1[0] * u0[0] + fv1[1] * u0[1] + fv1[2] * u0[2]
    u1r = [a - d01 * b for a, b in zip(fv1, u0)]
    use_a = u0[0].abs() < 0.9
    alt_a = [zero, -u0[2], u0[1]]
    alt_b = [u0[2], zero, -u0[0]]
    alt = [torch.where(use_a, a, b) for a, b in zip(alt_a, alt_b)]
    nalt = _norm3(*alt)
    alt = [x / torch.clamp(nalt, min=1e-30) for x in alt]
    u1 = normalize(u1r, alt)
    u2 = [
        u0[1] * u1[2] - u0[2] * u1[1],
        u0[2] * u1[0] - u0[0] * u1[2],
        u0[0] * u1[1] - u0[1] * u1[0],
    ]
    detf = det3_ch(fc)
    sig[2] = sig[2] * torch.where(detf < 0, -1.0, 1.0)
    return [u0, u1, u2], sig, vc


def det3_ch(fc):
    return (
        fc[(0, 0)] * (fc[(1, 1)] * fc[(2, 2)] - fc[(1, 2)] * fc[(2, 1)])
        - fc[(0, 1)] * (fc[(1, 0)] * fc[(2, 2)] - fc[(1, 2)] * fc[(2, 0)])
        + fc[(0, 2)] * (fc[(1, 0)] * fc[(2, 1)] - fc[(1, 1)] * fc[(2, 0)])
    )


def eig33_sigma_ch(fc, sweeps: int = 8):
    """Singular values only (the fracture check): same sweeps, no U/V."""
    sym = _sym_ftf(fc)
    for _ in range(sweeps):
        sym, _ = _jacobi_rot(sym, None, 0, 1)
        sym, _ = _jacobi_rot(sym, None, 0, 2)
        sym, _ = _jacobi_rot(sym, None, 1, 2)
    return [torch.sqrt(torch.clamp(sym[(k, k)], min=0.0)) for k in range(3)]


def _stack_matrix(uc, sig, vc):
    """(U, S, V^T) as [..., d, d], [..., d], [..., d, d] from the channel
    forms' columns uc, vc and values sig."""
    u = torch.stack([torch.stack(col, dim=-1) for col in uc], dim=-1)
    vt = torch.stack([torch.stack(col, dim=-1) for col in vc], dim=-2)
    return u, torch.stack(sig, dim=-1), vt


def svd2x2(f):
    """Signed SVD of [..., 2, 2] matrices: (U, S, V^T) with U, V in SO(2),
    S = [s0, s1], s0 >= |s1| and sign(s1) = sign(det f)."""
    return _stack_matrix(*svd2x2_ch({(i, j): f[..., i, j]
                                     for i in range(2) for j in range(2)}))


def svd3x3(f, sweeps: int = 8):
    """Signed SVD of [..., 3, 3] matrices by `sweeps` cyclic Jacobi sweeps
    on F^T F: (U, S, V^T) with U, V in SO(3), S[..., 0] >= S[..., 1] >=
    |S[..., 2]| and sign(S[..., 2]) = sign(det f)."""
    return _stack_matrix(*svd3x3_ch({(i, j): f[..., i, j]
                                     for i in range(3) for j in range(3)}, sweeps))


def svd(f, sweeps: int = 8):
    """svd2x2 or svd3x3 by the size of the [..., d, d] blocks."""
    d = f.shape[-1]
    if d == 2:
        return svd2x2(f)
    if d == 3:
        return svd3x3(f, sweeps=sweeps)
    raise ValueError(f"svd only supports 2x2 or 3x3 blocks, got d={d}")


def recompose(u, s, vt):
    """U diag(S) V^T."""
    return torch.einsum("...ik,...k,...kj->...ij", u, s, vt)
