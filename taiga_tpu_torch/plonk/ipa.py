"""Inner-product-argument polynomial commitment: verification.

The verifying half of taiga_tpu/plonk/ipa.py (`ipa_verify`), on the native
engine. The prover's IPA open is plonk/native_open.py::ipa_open_native.

Protocol (coefficient basis; C = <a, G> + [blind] W claimed to open to
v = a(x) with b = (1, x, ..., x^{n-1})): the prover commits a randomizer S
with s(x) = 0 (challenge xi), mixes the value into U' = [z] U, runs k
halving rounds with L_j, R_j and challenges u_j, and reveals a_0 and the
synthetic blind f; the verifier checks
  P + sum(u_j L_j + u_j^{-1} R_j) == [a_0] G_0 + [a_0 b_0] U' + [f] W
with G_0 = <s, G> and b_0 = prod(1 + u_j^{-1} x^{n/2^j}), as ONE MSM.
"""

from __future__ import annotations

from ..crypto.curves import VestaPoint
from ..crypto.fields import Fp
from .srs import Params
from .transcript import ProofReader

P = Fp.MODULUS


def ipa_verify(
    params: Params,
    terms: list[tuple[VestaPoint, int]],
    x: int,
    v: int,
    transcript: ProofReader,
    claim=None,
) -> bool:
    """Verify an IPA opening to value v at point x of the commitment given as
    a weighted point list `terms` (the multiopen aggregate, kept unevaluated
    so everything lands in ONE MSM). With `claim` (an MSMClaim), the check is
    deferred into the claim (batch verification); otherwise it is evaluated
    immediately on the native engine, which must be available."""
    n, k = params.n, params.k
    c_s = transcript.read_point()
    xi = transcript.challenge(b"ipa-xi").v
    z = transcript.challenge(b"ipa-z").v
    lr = []
    us = []
    for _ in range(k):
        l_pt = transcript.read_point()
        r_pt = transcript.read_point()
        u = transcript.challenge(b"ipa-u").v
        us.append(u)
        lr.append((l_pt, r_pt))
    a0 = transcript.read_scalar().v
    f = transcript.read_scalar().v

    # b_0 = prod_j (1 + u_j^{-1} x^{n / 2^j})
    b0 = 1
    for j, u in enumerate(us):
        e = pow(x, n >> (j + 1), P)
        b0 = b0 * (1 + pow(u, -1, P) * e) % P

    # Claim: P_acc - RHS == identity, with
    #   P_acc = sum(terms) + xi*C_s + z*v*U + sum_j (u_j L_j + u_j^{-1} R_j)
    #   RHS   = a0*<s, G> + z*(a0 b0)*U + f*W
    from ..native import hostops as H
    from .msm_claim import MSMClaim, s_vec_mont

    if not H.available():
        raise RuntimeError("ipa_verify needs the native host engine (g++ build failed)")
    own = claim is None
    if own:
        claim = MSMClaim(k)
        claim.begin_proof(first=True)
    for pt, sc in terms:
        claim.add_term(pt, sc)
    claim.add_term(c_s, xi)
    claim.add_term(params.u, z * (v - a0 * b0) % P)
    claim.add_term(params.w, (-f) % P)
    for (l_pt, r_pt), u in zip(lr, us):
        claim.add_term(l_pt, u)
        claim.add_term(r_pt, pow(u, -1, P))
    claim.add_g_vector_mont(s_vec_mont(us, k), (-a0) % P)
    return claim.check() if own else True
