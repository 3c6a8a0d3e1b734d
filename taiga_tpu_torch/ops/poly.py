"""Polynomial primitives: powers, dot products, cumulative products, suffix
sums, and batched evaluation — the building blocks that keep the prover's
multiopen and permutation math on the device.

Port of taiga_tpu/ops/poly.py. All values are (..., 16) int32 Montgomery
limb tensors over Fp. Field addition and multiplication are exact, so the
scans here (K9, ff_kernels.mont_cumprod_lm, and Hillis-Steele doubling in
place of the reference's associative_scan) and the powers (K9's powers
entry, ff_kernels.powers_lm: tables in place of a scan) give the
reference's values bit for bit.

The three programs of the query evaluations and the multiopen route to
their hand kernels (ff_kernels: K12 eval_polys_lm, K13 linear_combo_lm,
K14 synthetic_div_lm, csrc/poly.cu); their plain versions are the
*_plain functions here.
"""

from __future__ import annotations

import torch

from . import ff_kernels as FK
from . import limbs as L


def _spec(field: str) -> L.FieldSpec:
    return L.FIELDS[field]


def mont_cumprod(a, field: str = "fp"):
    """Inclusive cumulative product along axis 0 (K9)."""
    return FK.mont_cumprod_lm(a.movedim(0, -2), field).movedim(-2, 0)


def mod_cumsum(a, field: str = "fp"):
    """Inclusive cumulative sum along axis 0 (mod p)."""
    spec = _spec(field)
    return L.from_lm(L.lm_scan(L.to_lm(a), lambda x, y: L.lm_add(x, y, spec), dim=1))


def powers(x_mont, n: int, field: str = "fp"):
    """[1, x, x^2, ..., x^(n-1)] as (..., n, 16) Montgomery limbs for x of
    shape (..., 16) (K9's powers entry, ff_kernels.powers_lm)."""
    return FK.powers_lm(x_mont, n, field)


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


def eval_polys_plain(coeffs, points, field: str = "fp"):
    """Plain version of K12: eval_polys_at_points as eager limb ops (the
    powers table, one broadcast product, a halving-tree sum)."""
    n = coeffs.shape[-2]
    pw = powers(points, n, field)  # (..., Q, n, 16)
    prod = L.mont_mul(pw.unsqueeze(-3), coeffs.unsqueeze(-4), _spec(field))
    return tree_sum(prod, axis=-2, field=field)


def synthetic_div_plain(coeffs, point, point_inv, field: str = "fp"):
    """Plain version of K14: synthetic_div as eager limb ops (two powers
    tables, the suffix sums as a flipped Hillis-Steele scan)."""
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


def linear_combo_plain(coeffs_stack, weights, field: str = "fp"):
    """Plain version of K13: mont_linear_combo as one broadcast product and
    a halving-tree sum over the columns."""
    prod = L.mont_mul(coeffs_stack, weights.unsqueeze(-2), _spec(field))
    return tree_sum(prod, axis=-3, field=field)


def linear_combo_groups_plain(coeffs_stack, cols, sizes, weights, addend=None,
                              field: str = "fp"):
    """Plain version of K13's grouped form, the reference's route
    (taiga_tpu/plonk/hybrid_open.py agg_fn and f_fn): each group's columns
    gathered (index_select), its weighted sum (linear_combo_plain), the
    groups stacked on a new axis -3, then the addend added (L.add)."""
    sel = coeffs_stack if cols is None else coeffs_stack.index_select(
        -3, torch.as_tensor(cols, dtype=torch.int64, device=coeffs_stack.device))
    outs, off = [], 0
    for sz in sizes:
        outs.append(linear_combo_plain(sel[..., off : off + sz, :, :],
                                       weights[..., off : off + sz, :], field))
        off += sz
    out = torch.stack(outs, dim=-3)
    return out if addend is None else L.add(out, addend, _spec(field))


def eval_polys_at_points(coeffs, points, field: str = "fp"):
    """Evaluate C polynomials at Q points: coeffs (..., C, n, 16), points
    (..., Q, 16) Montgomery -> (..., Q, C, 16) Montgomery values; the
    leading axes (a batch of proofs) pair each stack with its points (K12)."""
    return FK.eval_polys_lm(coeffs, points, field)


def synthetic_div(coeffs, point, point_inv, field: str = "fp"):
    """q(X) = (A(X) - A(p)) / (X - p) for coeffs (..., n, 16) and a point
    (16,) with its inverse, or one point (..., 16) per polynomial:
    q_i = p^{-(i+1)} * sum_{j>i} a_j p^j, scaled by the given point_inv's
    powers (K14)."""
    return FK.synthetic_div_lm(coeffs, point, point_inv, field)


def mont_linear_combo(coeffs_stack, weights, field: str = "fp"):
    """sum_c weights[c] * coeffs_stack[c]: (..., C, n, 16) x (..., C, 16)
    -> (..., n, 16) (K13)."""
    return FK.linear_combo_lm(coeffs_stack, weights, field)


def mont_linear_combo_groups(coeffs_stack, cols, sizes, weights, addend=None,
                             field: str = "fp"):
    """The weighted sums of G groups of a stack's columns in one launch
    (K13): group g's terms s (sizes[g] of them, in order) each weights[s] *
    coeffs_stack[cols[s]] (cols None: column s), plus addend[g]:
    (..., C, n, 16), S column indices, G sizes summing to S, (..., S, 16)
    and (..., G, n, 16) or None -> (..., G, n, 16). The multiopen's
    point-group aggregates (agg_fn) and its f = h + sum_j w^(j+1) agg_j
    (f_fn, one group with h as its addend)."""
    return FK.linear_combo_lm(coeffs_stack, weights, field, cols, sizes, addend)
