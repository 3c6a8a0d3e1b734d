"""Native-engine (C++) IPA open: the host tail of the prover.

Copy of the IPA open of taiga_tpu/plonk/native_open.py. The threaded C++
engine (native/src/pasta_host.cpp) runs the k halving rounds — vector field
ops, Pippenger MSMs for L/R, and the per-round G folds — on numpy buffers.
Every blind is drawn through the caller's `randbits`, in the reference's
order, so a seeded generator reproduces the reference's proof bytes.

Transcript semantics are identical to the reference: proofs verify under
the same verifier.
"""

from __future__ import annotations

import numpy as np

from ..crypto.fields import Fp
from ..native import FIELD_FP, FIELD_FQ, hostops as H
from .msm_claim import srs_host_rows
from .srs import Params, get_params
from .transcript import ProofWriter

P = Fp.MODULUS


def _rand(randbits) -> int:
    return randbits(300) % P


def _mont1(v: int) -> np.ndarray:
    return H.to_mont(FIELD_FP, H.ints_to_u64([v % P]))[0]


def _msm_point(k: int, scalars_plain: np.ndarray, blind: int = 0):
    from ..crypto.curves import VestaPoint

    rows = srs_host_rows(k)[: scalars_plain.shape[0]]
    x, y, inf = H.msm(FIELD_FQ, rows, scalars_plain)
    pt = VestaPoint.identity() if inf else VestaPoint.from_xy(x, y)
    if blind:
        pt = pt + get_params(k).w * blind
    return pt


def _rows_msm(rows9: np.ndarray, scalars_plain: np.ndarray):
    from ..crypto.curves import VestaPoint

    x, y, inf = H.msm(FIELD_FQ, rows9, scalars_plain)
    return VestaPoint.identity() if inf else VestaPoint.from_xy(x, y)


def draws(k: int) -> int:
    """How many values ipa_open_native draws from its `randbits` at 2^k:
    the n - 1 coefficients of t(X), s's blind, and two blinds a round."""
    return (1 << k) - 1 + 1 + 2 * k


def ipa_open_native(params: Params, coeffs_mont: np.ndarray, blind: int,
                    x: int, tr: ProofWriter, randbits):
    """Native IPA open of (n, 4) u64 Montgomery coefficients; transcript-
    identical to the reference's ipa_open_native."""
    n, k = params.n, params.k

    # 1. randomizer s(X) = t(X) * (X - x), s(x) = 0
    t = [_rand(randbits) for _ in range(n - 1)]
    s = [0] * n
    for i, ti in enumerate(t):
        s[i + 1] = (s[i + 1] + ti) % P
        s[i] = (s[i] - ti * x) % P
    s_blind = _rand(randbits)
    s_mont = H.to_mont(FIELD_FP, H.ints_to_u64(s))
    c_s = _msm_point(k, H.ints_to_u64(s), s_blind)
    tr.write_point(c_s)
    xi = tr.challenge(b"ipa-xi").v
    a = H.vec_add(FIELD_FP, coeffs_mont, H.vec_mul(FIELD_FP, s_mont, _mont1(xi)))
    blind = (blind + xi * s_blind) % P

    # 2. value mix
    z = tr.challenge(b"ipa-z").v
    u_prime = params.u * z

    # 3. rounds
    b = H.powers(FIELD_FP, _mont1(x), n)
    g_rows = srs_host_rows(k).copy()
    f = blind
    for _ in range(k):
        half = a.shape[0] // 2
        a_lo, a_hi = a[:half], a[half:]
        b_lo, b_hi = b[:half], b[half:]
        g_lo, g_hi = g_rows[:half], g_rows[half:]
        lb, rb = _rand(randbits), _rand(randbits)
        ip_l = int(
            H.u64_to_ints(
                H.from_mont(
                    FIELD_FP,
                    H.vec_sum(FIELD_FP, H.vec_mul(FIELD_FP, a_hi, b_lo)),
                )
            )[0]
        )
        ip_r = int(
            H.u64_to_ints(
                H.from_mont(
                    FIELD_FP,
                    H.vec_sum(FIELD_FP, H.vec_mul(FIELD_FP, a_lo, b_hi)),
                )
            )[0]
        )
        l_pt = _rows_msm(g_lo, H.from_mont(FIELD_FP, a_hi))
        r_pt = _rows_msm(g_hi, H.from_mont(FIELD_FP, a_lo))
        l_pt = l_pt + params.w * lb + u_prime * ip_l
        r_pt = r_pt + params.w * rb + u_prime * ip_r
        tr.write_point(l_pt)
        tr.write_point(r_pt)
        u = tr.challenge(b"ipa-u").v
        u_inv = pow(u, -1, P)
        um = _mont1(u)
        uim = _mont1(u_inv)
        a = H.vec_add(FIELD_FP, a_lo, H.vec_mul(FIELD_FP, a_hi, um))
        b = H.vec_add(FIELD_FP, b_lo, H.vec_mul(FIELD_FP, b_hi, uim))
        g_rows = H.ec_fold(FIELD_FQ, g_lo, g_hi, u_inv)
        f = (f + u * lb + u_inv * rb) % P

    a0 = H.u64_to_ints(H.from_mont(FIELD_FP, a))[0]
    tr.write_scalar(Fp(a0))
    tr.write_scalar(Fp(f))
