"""Hybrid multiopen: device-side aggregation, then the IPA open.

Port of the single-proof path of taiga_tpu/plonk/hybrid_open.py. The
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
The two write the same transcript bytes under the same randbits.

Transcript framing is identical to the reference: proofs verify under the
unchanged verifier.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.fields import Fp
from ..ops import limbs as L, poly
from .srs import get_params

P = Fp.MODULUS


def _mont(v: int, device):
    return L.const(L.int_to_limbs(v * L.FP.r % P), device)


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


def _build_programs(group_sizes: tuple[int, ...]):
    """The three device stages for a fixed group structure (the reference
    jits them; here they are plain functions over tensors)."""

    def agg_fn(all_coeffs, idxs, weights):
        outs = []
        off = 0
        for sz in group_sizes:
            sel = all_coeffs.index_select(0, idxs[off : off + sz])
            outs.append(poly.mont_linear_combo(sel, weights[off : off + sz]))
            off += sz
        return torch.stack(outs)  # (G, n, 16)

    def h_fn(agg, pts_m, pts_inv_m, u_pows):
        q = torch.stack([poly.synthetic_div(c, p, pi)
                         for c, p, pi in zip(agg, pts_m, pts_inv_m)])
        return poly.mont_linear_combo(q, u_pows)

    def f_fn(h, agg, w_pows):
        return L.add(h, poly.mont_linear_combo(agg, w_pows), L.FP)

    return agg_fn, h_fn, f_fn


IPA_OPENS = ("native", "device")


def multiopen_open_hybrid(pipe, all_coeffs, entries, tr, randbits, ipa: str = "native"):
    """Aggregate + open. all_coeffs: (C, n, 16) device Montgomery coefficient
    stack; entries: [{coeff_idx, blind, point, value}] in query order; ipa:
    "native" or "device", the IPA open of the aggregate."""
    if ipa not in IPA_OPENS:
        raise ValueError(f"ipa must be one of {IPA_OPENS}, not {ipa!r}")
    if ipa == "native":
        from ..native import hostops as H

        if not H.available():
            raise RuntimeError("the native IPA open needs the native host engine (g++ build failed)")
    dev = all_coeffs.device
    params = get_params(pipe.k)
    v_ch = tr.challenge(b"mo-v").v
    groups, order = _group_entries(entries)
    sizes = tuple(len(groups[p]) for p in order)
    agg_fn, h_fn, f_fn = _build_programs(sizes)

    idxs = []
    weights = []
    blinds = []
    for ptv in order:
        vp = 1
        blind = 0
        for e in groups[ptv]:
            idxs.append(e["coeff_idx"])
            weights.append(vp)
            blind = (blind + vp * e["blind"]) % P
            vp = vp * v_ch % P
        blinds.append(blind)
    idxs_dev = torch.as_tensor(np.asarray(idxs, np.int64), device=dev)
    w_dev = L.const(np.stack([L.int_to_limbs(w * L.FP.r % P) for w in weights]), dev)
    agg = agg_fn(all_coeffs, idxs_dev, w_dev)

    u_ch = tr.challenge(b"mo-u").v
    pts_m = torch.stack([_mont(p, dev) for p in order])
    pts_inv_m = torch.stack([_mont(pow(p, -1, P), dev) for p in order])
    u_pows = torch.stack([_mont(pow(u_ch, j, P), dev) for j in range(len(order))])
    h = h_fn(agg, pts_m, pts_inv_m, u_pows)

    h_blind = randbits(300) % P
    c_h = pipe.commit_coeff_rows(h[None], [h_blind])[0]
    tr.write_point(c_h)
    x3 = tr.challenge(b"mo-x3").v
    a_dev = poly.eval_polys_at_points(agg, _mont(x3, dev)[None])[0]  # (G, 16)
    a_vals = L.limbs_to_ints(L.from_mont(a_dev, L.FP))
    for av in a_vals:
        tr.write_scalar(Fp(av))

    w_ch = tr.challenge(b"mo-w").v
    w_pows = torch.stack([_mont(pow(w_ch, j + 1, P), dev) for j in range(len(order))])
    f = f_fn(h, agg, w_pows)
    f_blind = h_blind
    wp = w_ch
    for blind in blinds:
        f_blind = (f_blind + wp * blind) % P
        wp = wp * w_ch % P

    if ipa == "device":
        from .ipa import ipa_open_device

        ipa_open_device(params, f, f_blind, x3, tr, randbits)
    else:
        from .native_open import ipa_open_native

        ipa_open_native(params, L.packed_to_u64(L.pack_limbs(f)), f_blind, x3, tr, randbits)
