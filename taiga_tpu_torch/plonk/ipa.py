"""Inner-product-argument polynomial commitment: the opens and the
verifier.

Port of taiga_tpu/plonk/ipa.py: `ipa_open_device` (the a/b/G folds, inner
products and L/R MSMs on the device, with the transcript and the challenge
scalars on the host), the list-based `ipa_open` (host-int coefficients,
moved to the device and opened there by ipa_open_device) and `ipa_verify`.
The native engine's open is plonk/native_open.py::ipa_open_native; the
opens draw every blind through the caller's `randbits` in the same order
and write the same transcript, so the opens of one polynomial under one
seed give the same bytes.

Protocol (coefficient basis; C = <a, G> + [blind] W claimed to open to
v = a(x) with b = (1, x, ..., x^{n-1})): the prover commits a randomizer S
with s(x) = 0 (challenge xi), mixes the value into U' = [z] U, runs k
halving rounds with L_j, R_j and challenges u_j, and reveals a_0 and the
synthetic blind f; the verifier checks
  P + sum(u_j L_j + u_j^{-1} R_j) == [a_0] G_0 + [a_0 b_0] U' + [f] W
with G_0 = <s, G> and b_0 = prod(1 + u_j^{-1} x^{n/2^j}), as ONE MSM.
"""

from __future__ import annotations

import torch

from ..crypto.curves import VestaPoint
from ..crypto.fields import Fp
from ..ops import ec, ff_kernels as FK, limbs as L, msm as msm_mod, poly
from .srs import Params, srs_device
from .transcript import LazyPoint, ProofReader, ProofWriter

P = Fp.MODULUS


def _rand(randbits) -> int:
    return randbits(300) % P


def _mont(v: int, device) -> torch.Tensor:
    return L.const(L.int_to_limbs(v * L.FP.r % P), device)


def _srs(k: int, device):
    """The SRS generators as (n, 16) x3 Jacobian Montgomery rows on `device`."""
    return tuple(L.const(t, device) for t in srs_device(k))


def ipa_open_device(params: Params, coeffs_mont: torch.Tensor, blind: int, x: int,
                    transcript: ProofWriter, randbits):
    """Device-resident IPA open of (n, 16) int32 Montgomery coefficients:
    the a/b/G folds, inner products and L/R MSMs run on their device; the
    transcript and the challenge scalars stay on the host. Every blind comes
    from `randbits`: t (n - 1 values), then s_blind, then lb, rb each round."""
    n, k = params.n, params.k
    dev = coeffs_mont.device

    # 1. randomizer s(X) = t(X) * (X - x), s(x) = 0
    t = [_rand(randbits) for _ in range(n - 1)]
    s = [0] * n
    for i, ti in enumerate(t):
        s[i + 1] = (s[i + 1] + ti) % P
        s[i] = (s[i] - ti * x) % P
    s_blind = _rand(randbits)
    s_mont = L.const(L.FP.array_to_mont(s), dev)
    c_s = _commit_mont(params, s_mont, s_blind)
    transcript.write_point(c_s)
    xi = transcript.challenge(b"ipa-xi").v
    a = L.add(coeffs_mont, L.mont_mul(s_mont, _mont(xi, dev), L.FP), L.FP)
    blind = (blind + xi * s_blind) % P

    # 2. value mix
    z = transcript.challenge(b"ipa-z").v
    u_prime = params.u * z

    # 3. rounds, on limb-major PROJECTIVE generators (the SRS is affine, so
    # the initial coordinates coincide). Rounds below n//16 run padded
    # (identity points + zero scalars contribute nothing), as in the
    # reference, whose padding bounds its compiled MSM shapes: at k = 13 the
    # MSM widths are 8192, 4096, 2048 and then 1024 for every later round.
    b = poly.powers(_mont(x, dev), n, "fp")
    g_dev = tuple(v.T.contiguous() for v in _srs(k, dev))  # (16, n)
    buckets = sorted({max(n // 2, 1), max(n // 4, 1), max(n // 16, 16)}, reverse=True)

    def bucket_of(sz):
        for bk in buckets:
            if sz >= bk:
                return bk
        return buckets[-1]

    f = blind
    for _ in range(k):
        half = a.shape[0] // 2
        a_lo, a_hi = a[:half], a[half:]
        b_lo, b_hi = b[:half], b[half:]
        g_lo = tuple(v[:, :half].contiguous() for v in g_dev)
        g_hi = tuple(v[:, half:].contiguous() for v in g_dev)
        lb, rb = _rand(randbits), _rand(randbits)
        ip_l, ip_r = L.limbs_to_ints(_ipa_dots(a_lo, a_hi, b_lo, b_hi))
        # ONE batched 2-column MSM over the shared (full-width) generator set:
        #   L = <a_hi, G_lo>  -> col 0 scalars [a_hi | 0]
        #   R = <a_lo, G_hi>  -> col 1 scalars [0 | a_lo]
        pad = max(0, 2 * bucket_of(half) - 2 * half)
        l_pt, r_pt = _lr_msm(g_dev, a_lo, a_hi, pad)
        l_pt = l_pt + params.w * lb + u_prime * ip_l
        r_pt = r_pt + params.w * rb + u_prime * ip_r
        transcript.write_point(l_pt)
        transcript.write_point(r_pt)
        u = transcript.challenge(b"ipa-u").v
        u_inv = pow(u, -1, P)
        a, b = _ipa_fold_ab(a_lo, a_hi, b_lo, b_hi, _mont(u, dev), _mont(u_inv, dev))
        g_dev = FK.ec_fold_shared_lm(*g_lo, *g_hi, L.const(L.int_to_limbs(u_inv), dev)[None, :],
                                     field="fq")
        f = (f + u * lb + u_inv * rb) % P

    a0 = L.FP.from_mont_host(a[0].cpu().numpy())
    transcript.write_scalar(Fp(a0))
    transcript.write_scalar(Fp(f))


def ipa_open(params: Params, coeffs: list[int], blind: int, x: int, transcript: ProofWriter,
             randbits, device="cuda"):
    """Open the polynomial given as a list of n coefficients (host ints) at
    x; writes the IPA proof. The coefficients go to `device` ("cuda" unless
    the caller asks for "cpu") in Montgomery form and ipa_open_device opens
    them: the same draws, the same bytes."""
    if len(coeffs) != params.n:
        raise ValueError(f"{len(coeffs)} coefficients, expected {params.n}")
    mont = L.const(L.FP.array_to_mont([c % P for c in coeffs]), L.resolve_device(device))
    ipa_open_device(params, mont, blind, x, transcript, randbits)


def _pad_pts_lm(pts, pad: int):
    """Pad limb-major projective points with identities (0:1:0). The
    coordinate field of Vesta points is Fq."""
    if not pad:
        return pts
    x, y, z = pts
    zeros = x.new_zeros((L.NLIMBS, pad))
    one = L.FQ.one_col(x.device).expand(L.NLIMBS, pad)
    return (torch.cat([x, zeros], dim=1), torch.cat([y, one], dim=1),
            torch.cat([z, zeros], dim=1))


def _lr_msm(g_dev, a_lo, a_hi, pad: int):
    """The IPA round's L/R commitments as one 2-column shared-point MSM:
    col0 = [a_hi | 0] (pairs with G_lo), col1 = [0 | a_lo] (pairs with G_hi).
    a_* are (half, 16) Montgomery; g_dev is limb-major projective (16, W)."""
    cols = _lr_cols(a_lo, a_hi)
    if pad:
        cols = torch.cat([cols, cols.new_zeros((2, pad, L.NLIMBS))], dim=1)
    out = msm_mod.msm_multi(*_pad_pts_lm(g_dev, pad), cols, field="fq", in_form="projective")
    pts = ec.points_from_device((out[:, 0], out[:, 1], out[:, 2]), VestaPoint)
    return pts[0], pts[1]


def _lr_cols(a_lo, a_hi):
    z = torch.zeros_like(a_lo)
    col0 = torch.cat([a_hi, z], dim=0)
    col1 = torch.cat([z, a_lo], dim=0)
    return FK.from_mont_lm(torch.stack([col0, col1]))


def _ipa_dots(a_lo, a_hi, b_lo, b_hi):
    """<a_hi, b_lo> and <a_lo, b_hi> as (2, 16) plain limbs."""
    ip_l = poly.mont_dot(a_hi, b_lo, "fp")
    ip_r = poly.mont_dot(a_lo, b_hi, "fp")
    return torch.stack([FK.from_mont_lm(ip_l), FK.from_mont_lm(ip_r)])


def _ipa_fold_ab(a_lo, a_hi, b_lo, b_hi, u_m, uinv_m):
    a = L.add(a_lo, L.mont_mul(a_hi, u_m, L.FP), L.FP)
    b = L.add(b_lo, L.mont_mul(b_hi, uinv_m, L.FP), L.FP)
    return a, b


def _msm_mont(g_parts, scalars_mont) -> VestaPoint:
    plain = FK.from_mont_lm(scalars_mont)
    out = msm_mod.msm(g_parts[0], g_parts[1], g_parts[2], plain, field="fq")
    return ec.points_from_device((out[0][None], out[1][None], out[2][None]), VestaPoint)[0]


def _commit_mont(params: Params, coeffs_mont, blind: int) -> VestaPoint:
    return _msm_mont(_srs(params.k, coeffs_mont.device), coeffs_mont) + params.w * blind


def ipa_verify(
    params: Params,
    terms: list[tuple[VestaPoint, int]],
    x: int,
    v: int,
    transcript: ProofReader,
    claim=None,
    msm_device=None,
) -> bool:
    """Verify an IPA opening to value v at point x of the commitment given as
    a weighted point list `terms` (the multiopen aggregate, kept unevaluated
    so everything lands in ONE MSM). With `claim` (an MSMClaim), the check is
    deferred into the claim (batch verification). With `msm_device` (a torch
    device), the check is evaluated at once by host point arithmetic and
    G_0 = <s, G> as one device MSM, the reference's branch without the native
    engine. Otherwise it is evaluated at once on the native engine, which
    must be available."""
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

    if msm_device is not None:
        if claim is not None:
            raise TypeError("ipa_verify: a claim defers the check; msm_device evaluates it now")
        return _check_on_device(params, terms, v, c_s, xi, z, lr, us, a0, b0, f,
                                L.resolve_device(msm_device))

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


def _check_on_device(params, terms, v, c_s, xi, z, lr, us, a0, b0, f, device) -> bool:
    """P_acc == RHS by host point arithmetic, with G_0 = <s, G> one device
    MSM (reference ipa_verify without the native engine). Proof points read
    lazily are decompressed here, in Python."""
    n, k = params.n, params.k
    pt_ = lambda p: p._resolve_now() if isinstance(p, LazyPoint) else p
    u_prime = params.u * z
    p_acc = VestaPoint.identity()
    for pt, sc in terms:
        p_acc = p_acc + pt_(pt) * sc
    p_acc = p_acc + pt_(c_s) * xi + u_prime * v
    for (l_pt, r_pt), u in zip(lr, us):
        p_acc = p_acc + pt_(l_pt) * u + pt_(r_pt) * pow(u, -1, P)
    s_vec = [1] * n
    for j, u in enumerate(us):
        u_inv = pow(u, -1, P)
        for i in range(n):
            if (i >> (k - 1 - j)) & 1:
                s_vec[i] = s_vec[i] * u_inv % P
    sl = L.const(msm_mod.scalars_to_limbs(s_vec), device)
    gx, gy, gz = _srs(k, device)
    out = msm_mod.msm(gx, gy, gz, sl, field="fq")
    g0 = ec.points_from_device((out[0][None], out[1][None], out[2][None]), VestaPoint)[0]
    rhs = g0 * a0 + u_prime * (a0 * b0 % P) + params.w * f
    return p_acc == rhs
