"""Hybrid multiopen: device-side aggregation, then the IPA open.

Port of taiga_tpu/plonk/hybrid_open.py, one proof or a lockstep batch. The
multiopen (shplonk-style per-point aggregation) is LINEAR in the committed
polynomials, so the whole reduction — per-point weighted sums, synthetic
division, the h/f assemblies — runs on the device where the coefficient
stacks already live; the h commitment goes through the prover's fixed-base
MSM. The caller picks the IPA open of the aggregate f, where the reference
picks by the native engine's presence:
  ipa="native"  f crosses to the host and the C++ engine opens it
                (plonk/native_open.py); without the engine this raises;
  ipa="device"  f stays on the device and plonk/ipa.py::ipa_open_device
                opens it (K5 folds, general MSMs); the engine is not touched.
The two write the same transcript bytes under the same randbits. A batch
of B proofs aggregates over a leading proof axis, commits its B h
polynomials in one MSM, pulls its B aggregates f in one copy and opens each
with the native engine, on up to 4 threads, as the reference does.

Transcript framing is identical to the reference: proofs verify under the
unchanged verifier.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..crypto.fields import Fp
from ..ops import ff_kernels as FK, limbs as L, poly
from .srs import get_params

P = Fp.MODULUS


def _group_entries(entries):
    """Group by point in order of first appearance (matches the verifier's
    replay over the same query order)."""
    groups: dict[int, list] = {}
    order: list[int] = []
    for e in entries:
        if e["point"] not in groups:
            groups[e["point"]] = []
            order.append(e["point"])
        groups[e["point"]].append(e)
    return groups, order


IPA_OPENS = ("native", "device")


def _aggregate(pipe, all_coeffs_b, entries_b, trs, h_blinds):
    """The multiopen of B proofs of one key up to the IPA open:
    all_coeffs_b (B, C, n, 16) Montgomery coefficients; entries_b, each
    proof's [{coeff_idx, blind, point, value}] in query order; trs, their
    transcripts; h_blinds, one blind a proof. Returns the aggregates f
    (B, n, 16) on the device, their blinds and each proof's x3."""
    dev = all_coeffs_b.device
    mont = lambda rows: L.const(np.stack([np.stack([L.int_to_limbs(v * L.FP.r % P) for v in r])
                                          for r in rows]), dev)
    v_chs = [tr.challenge(b"mo-v").v for tr in trs]
    per_proof = [_group_entries(entries) for entries in entries_b]
    groups0, order0 = per_proof[0]
    sizes = [len(groups0[p]) for p in order0]
    cols = [e["coeff_idx"] for p in order0 for e in groups0[p]]
    weights_b, blinds_b, orders = [], [], []
    for (groups, order), v_ch in zip(per_proof, v_chs):
        weights, blinds = [], []
        for ptv in order:
            vp = 1
            blind = 0
            for e in groups[ptv]:
                weights.append(vp)
                blind = (blind + vp * e["blind"]) % P
                vp = vp * v_ch % P
            blinds.append(blind)
        weights_b.append(weights)
        blinds_b.append(blinds)
        orders.append(order)
    # per point: the v-weighted sum of its polynomials, gathered in one launch
    agg = poly.mont_linear_combo_groups(all_coeffs_b, cols, sizes, mont(weights_b))  # (B, G, n, 16)

    u_chs = [tr.challenge(b"mo-u").v for tr in trs]
    G = len(sizes)
    q = poly.synthetic_div(agg, mont(orders), mont([[pow(p, -1, P) for p in o] for o in orders]))
    h = poly.mont_linear_combo(q, mont([[pow(u, j, P) for j in range(G)] for u in u_chs]))
    c_hs = pipe.commit_coeff_rows(h, h_blinds)
    x3s = []
    for tr, c_h in zip(trs, c_hs):
        tr.write_point(c_h)
        x3s.append(tr.challenge(b"mo-x3").v)
    a_dev = poly.eval_polys_at_points(agg, mont([[x3] for x3 in x3s]))[:, 0]  # (B, G, 16)
    a_vals = L.limbs_to_ints(FK.from_mont_lm(a_dev))
    w_chs = []
    for bi, tr in enumerate(trs):
        for av in a_vals[bi * G : (bi + 1) * G]:
            tr.write_scalar(Fp(av))
        w_chs.append(tr.challenge(b"mo-w").v)
    f = poly.mont_linear_combo_groups(  # h + sum_j w^(j+1) agg_j, one launch
        agg, None, (G,), mont([[pow(w, j + 1, P) for j in range(G)] for w in w_chs]),
        addend=h[:, None])[:, 0]
    f_blinds = []
    for h_blind, blinds, w_ch in zip(h_blinds, blinds_b, w_chs):
        f_blind = h_blind
        wp = w_ch
        for blind in blinds:
            f_blind = (f_blind + wp * blind) % P
            wp = wp * w_ch % P
        f_blinds.append(f_blind)
    return f, f_blinds, x3s


def _need_native_engine():
    from ..native import hostops as H

    if not H.available():
        raise RuntimeError("the native IPA open needs the native host engine (g++ build failed)")


def multiopen_open_hybrid(pipe, all_coeffs, entries, tr, randbits, ipa: str = "native"):
    """Aggregate + open. all_coeffs: (C, n, 16) device Montgomery coefficient
    stack; entries: [{coeff_idx, blind, point, value}] in query order; ipa:
    "native" or "device", the IPA open of the aggregate."""
    if ipa not in IPA_OPENS:
        raise ValueError(f"ipa must be one of {IPA_OPENS}, not {ipa!r}")
    if ipa == "native":
        _need_native_engine()
    params = get_params(pipe.k)
    h_blind = randbits(300) % P
    f, f_blinds, x3s = _aggregate(pipe, all_coeffs[None], [entries], [tr], [h_blind])
    if ipa == "device":
        from .ipa import ipa_open_device

        ipa_open_device(params, f[0], f_blinds[0], x3s[0], tr, randbits)
    else:
        from .native_open import ipa_open_native

        ipa_open_native(params, L.packed_to_u64(L.pack_limbs(f[0])), f_blinds[0], x3s[0], tr,
                        randbits)


class _Drawn:
    """A randbits(300) over values drawn beforehand, in order: a native IPA
    open on a worker thread draws nothing from the caller's generator."""

    def __init__(self, values: list[int]):
        self.values = values
        self.used = 0

    def __call__(self, nbits: int) -> int:
        if nbits != 300 or self.used == len(self.values):
            raise RuntimeError(f"draw {self.used} of {nbits} bits: not among the "
                               f"{len(self.values)} 300-bit values drawn beforehand")
        self.used += 1
        return self.values[self.used - 1]


def multiopen_open_hybrid_batch(pipe, all_coeffs_b, entries_b, trs, h_blinds, tail_values):
    """Batched hybrid multiopen of B proofs of one key: the aggregation and
    the f build over the proof axis, ONE h-commit MSM, ONE pull of the B
    aggregates, then each proof's native IPA open, on up to 4 threads (the
    opens share no state; the engine's calls release the interpreter lock,
    the opens' Python point arithmetic holds it).

    all_coeffs_b: (B, C, n, 16); entries_b: per-proof entry lists; trs:
    per-proof transcripts; h_blinds: one h blind a proof; tail_values: each
    open's randbits(300) values, drawn beforehand
    (native_open.draws(k) a proof). Proofs finish in trs."""
    from .native_open import ipa_open_native

    _need_native_engine()
    params = get_params(pipe.k)
    f, f_blinds, x3s = _aggregate(pipe, all_coeffs_b, entries_b, trs, h_blinds)
    f_host = L.packed_to_u64(L.pack_limbs(f))  # (B, n, 4)

    def open_one(bi):
        rb = _Drawn(tail_values[bi])
        ipa_open_native(params, f_host[bi], f_blinds[bi], x3s[bi], trs[bi], rb)
        if rb.used != len(rb.values):
            raise RuntimeError(f"the IPA open drew {rb.used} of {len(rb.values)} values")

    with ThreadPoolExecutor(max_workers=min(4, len(trs))) as ex:
        list(ex.map(open_one, range(len(trs))))
