"""Proof verification.

Replays the transcript, recomputes the vanishing identity at the challenge
point from the claimed openings (+ transparent column evaluations), then
verifies the aggregated multiopen with a single IPA check (one device MSM).
Mirrors halo2's `plonk::verify_proof` + `SingleVerifier`
(taiga_halo2/src/proof.rs:45-54).
"""

from __future__ import annotations

from ..crypto.curves import VestaPoint
from ..crypto.fields import Fp
from .circuit import EXT_FACTOR
from .expression import ADVICE, FIXED, INSTANCE
from .ipa import ipa_verify
from .keygen import VerifyingKey
from .protocol import (
    L0,
    LBLIND,
    LLAST,
    LOOKUP_A,
    LOOKUP_S,
    LOOKUP_Z,
    NUM_H_PIECES,
    QUOTIENT,
    SIGMA,
    XID,
    Z,
    num_chunks,
    protocol_compiled,
    protocol_for,
    transparent_eval,
)
from .srs import get_params
from .transcript import ProofReader

P = Fp.MODULUS


def verify_proof(vk: VerifyingKey, instance: list[Fp], proof: bytes,
                 claim=None, msm_device=None) -> bool:
    """Verify one proof. With `claim` (an MSMClaim), the final MSM check is
    deferred into the claim — see BatchVerifier. With `msm_device` (a torch
    device), the final check is evaluated with <s, G> as one MSM on that
    device (plonk/ipa.py); otherwise on the native engine."""
    try:
        return _verify(vk, instance, proof, claim, msm_device)
    except (ValueError, AssertionError, KeyError):
        return False


class BatchVerifier:
    """Batch proof verification: every added proof's transcript is replayed
    and its vanishing identity checked immediately; the expensive MSM checks
    combine (with independent random weights) into ONE native MSM evaluated
    by finalize(). Counterpart of halo2's BatchVerifier — the reference
    verifies each proof's IPA separately (~36 ms each, Perfromance.md:4)."""

    def __init__(self):
        self._claim = None
        self._ok = True
        self._count = 0

    def add(self, vk: VerifyingKey, instance: list[Fp], proof: bytes):
        from ..native import hostops as H
        from .msm_claim import MSMClaim

        if not H.available():
            # no native engine: verify eagerly
            self._ok = self._ok and verify_proof(vk, instance, proof)
            return
        if self._claim is None or self._claim.k != vk.k:
            # claims share one SRS basis; a second domain size finalizes
            # the current claim first
            if self._claim is not None:
                self._ok = self._ok and self._claim.check()
            self._claim = MSMClaim(vk.k)
            self._count = 0
        self._claim.begin_proof(first=self._count == 0)
        self._count += 1
        self._ok = self._ok and verify_proof(vk, instance, proof, self._claim)

    def finalize(self) -> bool:
        ok = self._ok
        if self._claim is not None:
            ok = ok and self._claim.check()
            self._claim = None
        self._ok = True
        self._count = 0
        return ok


def _verify(vk: VerifyingKey, instance: list[Fp], proof: bytes,
            claim=None, msm_device=None) -> bool:
    k, n, u = vk.k, vk.n, vk.usable_rows
    cs = vk.cs
    omega = vk.omega
    inst = [v.v if isinstance(v, Fp) else int(v) % P for v in instance]
    params = get_params(k)

    tr = ProofReader(proof, b"taiga-tpu-plonk")
    tr.absorb_bytes(vk.digest)
    tr.absorb_bytes(len(inst).to_bytes(4, "little"))
    for v in inst:
        tr.absorb_scalar(Fp(v))

    advice_c = [tr.read_point() for _ in range(cs.num_advice)]
    theta = 0
    lk_ap_c, lk_sp_c = [], []
    if cs.lookups:
        theta = tr.challenge(b"theta").v
        for _ in cs.lookups:
            lk_ap_c.append(tr.read_point())
            lk_sp_c.append(tr.read_point())
    beta = tr.challenge(b"beta").v
    gamma = tr.challenge(b"gamma").v
    z_c = [tr.read_point() for _ in range(num_chunks(vk.perm_cols))]
    lk_z_c = [tr.read_point() for _ in cs.lookups]
    y = tr.challenge(b"y").v
    h_c = [tr.read_point() for _ in range(NUM_H_PIECES)]
    x = tr.challenge(b"x").v

    _, queries = protocol_for(vk)
    evals = {}
    for q in queries:
        evals[q] = tr.read_scalar().v

    # --- vanishing identity at x -------------------------------------
    transparent_memo: dict = {}

    def getter(kind, idx, rot):
        if (kind, idx, rot) in evals:
            return evals[(kind, idx, rot)]
        key = (kind, idx, rot)
        v = transparent_memo.get(key)
        if v is None:
            v = transparent_eval(kind, idx, rot, x, k, u, omega, inst)
            transparent_memo[key] = v
        return v

    acc_fn, cells = protocol_compiled(vk)
    acc = acc_fn([getter(*c) for c in cells], beta, gamma, theta, y, P)
    zh = (pow(x, n, P) - 1) % P
    t_x = 0
    xe = pow(x, n, P)
    for i in range(NUM_H_PIECES - 1, -1, -1):
        t_x = (t_x * xe + evals[(QUOTIENT, i, 0)]) % P
    if acc != zh * t_x % P:
        return False

    # --- multiopen ----------------------------------------------------
    commitments = {}
    for i, c in enumerate(advice_c):
        commitments[(ADVICE, i)] = c
    for i, c in enumerate(vk.fixed_commitments):
        commitments[(FIXED, i)] = c
    for i, c in enumerate(vk.sigma_commitments):
        commitments[(SIGMA, i)] = c
    for i, c in enumerate(z_c):
        commitments[(Z, i)] = c
    for i, c in enumerate(lk_ap_c):
        commitments[(LOOKUP_A, i)] = c
    for i, c in enumerate(lk_sp_c):
        commitments[(LOOKUP_S, i)] = c
    for i, c in enumerate(lk_z_c):
        commitments[(LOOKUP_Z, i)] = c
    for i, c in enumerate(h_c):
        commitments[(QUOTIENT, i)] = c

    v_ch = tr.challenge(b"mo-v").v
    groups: dict[int, list] = {}
    order = []
    for kind, idx, rot in queries:
        ptv = x * pow(omega, rot % n, P) % P
        if ptv not in groups:
            groups[ptv] = []
            order.append(ptv)
        groups[ptv].append((commitments[(kind, idx)], evals[(kind, idx, rot)]))

    agg = []
    for ptv in order:
        terms_j = []
        val = 0
        vp = 1
        for c_pt, e in groups[ptv]:
            terms_j.append((c_pt, vp))
            val = (val + vp * e) % P
            vp = vp * v_ch % P
        agg.append({"point": ptv, "terms": terms_j, "value": val})

    u_ch = tr.challenge(b"mo-u").v
    c_h = tr.read_point()
    x3 = tr.challenge(b"mo-x3").v
    a_vals = [tr.read_scalar().v for _ in agg]
    w_ch = tr.challenge(b"mo-w").v

    # H(x3) = sum u^j (A_j(x3) - a_j) / (x3 - p_j)
    h_x3 = 0
    up = 1
    for g, av in zip(agg, a_vals):
        denom = (x3 - g["point"]) % P
        if denom == 0:
            return False
        h_x3 = (h_x3 + up * (av - g["value"]) * pow(denom, -1, P)) % P
        up = up * u_ch % P

    # keep the aggregate commitment as an unevaluated term list so the whole
    # verification collapses into one MSM (msm_claim.py)
    f_terms = [(c_h, 1)]
    v_f = h_x3
    wp = w_ch
    for g, av in zip(agg, a_vals):
        for pt, sc in g["terms"]:
            f_terms.append((pt, sc * wp % P))
        v_f = (v_f + wp * av) % P
        wp = wp * w_ch % P

    ok = ipa_verify(params, f_terms, x3, v_f, tr, claim, msm_device=msm_device)
    return ok and tr.finished()
