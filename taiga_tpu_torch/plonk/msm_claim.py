"""Deferred-MSM verification claims.

A PLONK/IPA verification reduces to ONE claim of the form

    sum_i  s_i * G_i  +  sum_j  e_j * P_j  ==  identity

where G is the fixed SRS basis (the s-part comes from the IPA fold vector)
and P_j are per-proof commitments/transcript points. Representing the check
this way has two payoffs (mirroring halo2's `BatchVerifier` design):

  * the final MSM runs on the native engine (one threaded Pippenger call)
    instead of per-term Python point arithmetic;
  * claims from MANY proofs combine with independent random weights into a
    single MSM over the shared basis — `Transaction.execute` verifies a
    bundle's proofs at a fraction of the per-proof cost (the reference
    verifies serially at ~36 ms/proof, taiga_halo2 Perfromance.md:4).

Soundness of batching: each claim is scaled by an independent uniform weight
rho, so a false claim passes the combined check with probability 1/p.
"""

from __future__ import annotations

import secrets

import numpy as np

from ..crypto.fields import Fp
from .srs import get_params

P = Fp.MODULUS


def _rand_weight() -> int:
    return secrets.randbits(300) % P


class MSMClaim:
    """Accumulates weighted MSM terms; `check()` evaluates the combined MSM."""

    def __init__(self, k: int):
        self.k = k
        self.n = 1 << k
        self._g_scalars_mont = None  # (n, 4) u64 Montgomery accumulator
        self._extras: list[tuple[object, int]] = []  # (VestaPoint, scalar)
        self._weight = 1  # weight applied to the *current* proof's terms

    # --- per-proof weighting -------------------------------------------
    def begin_proof(self, first: bool):
        """Start a new proof's terms; independent random weight per proof
        (the first can keep weight 1 without loss of soundness)."""
        self._weight = 1 if first else _rand_weight()

    # --- term accumulation ----------------------------------------------
    def add_term(self, point, scalar: int):
        s = scalar * self._weight % P
        if s:
            self._extras.append((point, s))

    def add_g_vector_mont(self, s_vec_mont: np.ndarray, scale: int):
        """Accumulate scale * s_vec onto the SRS-basis scalars.
        s_vec_mont: (n, 4) uint64 Montgomery."""
        from ..native import FIELD_FP, hostops as H

        w = scale * self._weight % P
        scaled = H.vec_mul(FIELD_FP, s_vec_mont,
                           H.to_mont(FIELD_FP, H.ints_to_u64([w]))[0])
        if self._g_scalars_mont is None:
            self._g_scalars_mont = scaled
        else:
            self._g_scalars_mont = H.vec_add(FIELD_FP, self._g_scalars_mont, scaled)

    # --- evaluation ------------------------------------------------------
    def check(self) -> bool:
        """Evaluate the combined MSM on the native engine. Callers must
        gate on hostops.available() (ipa_verify falls back to the device
        path when the native toolchain is absent)."""
        from ..native import FIELD_FP, FIELD_FQ, hostops as H
        from .transcript import resolve_lazy_points

        try:
            # one native Tonelli-Shanks batch for every deferred proof point
            # accumulated across the whole claim (all proofs in the batch)
            resolve_lazy_points([p for p, _ in self._extras])
        except ValueError:
            return False  # malformed point encoding => invalid proof

        rows = []
        scalars = []
        if self._g_scalars_mont is not None:
            rows.append(srs_host_rows(self.k))
            scalars.append(np.asarray(H.from_mont(FIELD_FP, self._g_scalars_mont)))
        if self._extras:
            rows.append(H.points_to_rows([p for p, _ in self._extras]))
            scalars.append(H.ints_to_u64([s for _, s in self._extras]))
        if not rows:
            return True
        allrows = np.concatenate(rows, axis=0)
        allscalars = np.concatenate(scalars, axis=0)
        _, _, inf = H.msm(FIELD_FQ, allrows, allscalars)
        return inf


_SRS_ROWS_CACHE: dict[int, np.ndarray] = {}


def srs_host_rows(k: int) -> np.ndarray:
    """SRS G as (n, 9) u64 plain-form affine rows for the native MSM."""
    rows = _SRS_ROWS_CACHE.get(k)
    if rows is None:
        from ..native import hostops as H

        rows = H.points_to_rows(get_params(k).g)
        _SRS_ROWS_CACHE[k] = rows
    return rows


def s_vec_mont(us: list[int], k: int) -> np.ndarray:
    """The IPA fold vector s as (2^k, 4) u64 Montgomery:
    s[i] = prod_j u_j^{-bit_{k-1-j}(i)} (u_0 owns the most-significant bit).
    Built by log-doubling: n total field muls on the native engine."""
    from ..native import FIELD_FP, hostops as H

    us_inv = [pow(u, -1, P) for u in us]
    s = H.to_mont(FIELD_FP, H.ints_to_u64([1]))
    for j in range(k - 1, -1, -1):
        uj = H.to_mont(FIELD_FP, H.ints_to_u64([us_inv[j]]))[0]
        s = np.concatenate([s, H.vec_mul(FIELD_FP, s, uj)], axis=0)
    return s
