"""Polynomial primitives: powers, dot products, cumulative products, suffix
sums, and batched evaluation — the building blocks that keep the prover's
multiopen and permutation math on the device.

Port of taiga_tpu/ops/poly.py. All values are (..., 16) int32 Montgomery
limb tensors over Fp. Field addition and multiplication are exact, so the
scans here (Hillis-Steele doubling in place of the reference's
associative_scan) give the reference's values bit for bit.
"""

from __future__ import annotations

import torch

from . import limbs as L


def _spec(field: str) -> L.FieldSpec:
    return L.FIELDS[field]


def _scan(a, op, dim: int = 0):
    """Inclusive scan of a binary field op along `dim` of a limb-major int32
    tensor (log2(n) doubling rounds)."""
    n = a.shape[dim]
    s = 1
    while s < n:
        hi = a.narrow(dim, s, n - s)
        lo = a.narrow(dim, 0, n - s)
        a = torch.cat([a.narrow(dim, 0, s), op(hi, lo)], dim=dim)
        s *= 2
    return a


def mont_cumprod(a, field: str = "fp"):
    """Inclusive cumulative product along axis 0."""
    spec = _spec(field)
    return L.from_lm(_scan(L.to_lm(a), lambda x, y: L.lm_mul(x, y, spec), dim=1))


def mod_cumsum(a, field: str = "fp"):
    """Inclusive cumulative sum along axis 0 (mod p)."""
    spec = _spec(field)
    return L.from_lm(_scan(L.to_lm(a), lambda x, y: L.lm_add(x, y, spec), dim=1))


def powers(x_mont, n: int, field: str = "fp"):
    """[1, x, x^2, ..., x^(n-1)] as (..., n, 16) Montgomery limbs for x of
    shape (..., 16): one scan for every x."""
    spec = _spec(field)
    lead = tuple(x_mont.shape[:-1])
    xs = x_mont.reshape(1, -1, L.NLIMBS)
    pows = mont_cumprod(xs.expand(n - 1, xs.shape[1], L.NLIMBS), field)
    one = L.const(spec.one_mont, x_mont.device).expand(1, xs.shape[1], L.NLIMBS)
    return torch.cat([one, pows], dim=0).movedim(0, 1).reshape(lead + (n, L.NLIMBS))


def tree_sum(a, axis: int, field: str = "fp"):
    """Modular sum reduction along `axis` (log2 rounds of halving adds)."""
    spec = _spec(field)
    x = L.to_lm(a.movedim(axis, 0))  # (16, n, ...)
    n = x.shape[1]
    while n > 1:
        if n % 2:
            x = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
            n += 1
        x = L.lm_add(x[:, : n // 2], x[:, n // 2 :], spec)
        n = x.shape[1]
    return L.from_lm(x[:, 0])


def mont_dot(a, b, field: str = "fp"):
    """<a, b> over the last-but-one axis: a,b (..., n, 16) -> (..., 16)."""
    return tree_sum(L.mont_mul(a, b, _spec(field)), axis=-2, field=field)


def eval_polys_at_points(coeffs, points, field: str = "fp"):
    """Evaluate C polynomials at Q points: coeffs (..., C, n, 16), points
    (..., Q, 16) Montgomery -> (..., Q, C, 16) Montgomery values; the
    leading axes (a batch of proofs) pair each stack with its points."""
    n = coeffs.shape[-2]
    pw = powers(points, n, field)  # (..., Q, n, 16)
    prod = L.mont_mul(pw.unsqueeze(-3), coeffs.unsqueeze(-4), _spec(field))
    return tree_sum(prod, axis=-2, field=field)


def synthetic_div(coeffs, point, point_inv, field: str = "fp"):
    """q(X) = (A(X) - A(p)) / (X - p) for coeffs (..., n, 16) and a point
    (16,) with its inverse, or one point (..., 16) per polynomial:
    q_i = p^{-(i+1)} * sum_{j>i} a_j p^j."""
    spec = _spec(field)
    n = coeffs.shape[-2]
    pw = powers(point, n + 1, field)  # 1..p^n
    t = L.mont_mul(coeffs, pw[..., :n, :], spec)  # a_j p^j
    # suffix sums S_i = sum_{j>i} t_j  (reverse-cumsum exclusive)
    rev = torch.flip(t, dims=[-2])
    cs = mod_cumsum(rev.movedim(-2, 0), field).movedim(0, -2)
    incl = torch.flip(cs, dims=[-2])  # S_i inclusive: sum_{j>=i}
    excl = L.sub(incl, t, spec)  # sum_{j>i}
    ipw = powers(point_inv, n + 1, field)
    return L.mont_mul(excl, ipw[..., 1 : n + 1, :], spec)


def mont_linear_combo(coeffs_stack, weights, field: str = "fp"):
    """sum_c weights[c] * coeffs_stack[c]: (..., C, n, 16) x (..., C, 16)
    -> (..., n, 16)."""
    prod = L.mont_mul(coeffs_stack, weights.unsqueeze(-2), _spec(field))
    return tree_sum(prod, axis=-3, field=field)
