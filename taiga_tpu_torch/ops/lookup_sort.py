"""On-device lookup pair permutation (halo2 `lookup::permute_expression_pair`).

Port of taiga_tpu/ops/lookup_sort.py. Given the compressed input column A
and table column S (first `u` usable rows of each), produce:
  A' = A sorted (integer order — matches the host prover bit for bit);
  S' = for each run-start of A', the equal table value (consuming one copy
       from S — absence means the lookup FAILS); remaining positions filled
       with the leftover S values in sorted order.

`permute_pairs_device` runs K15 (ff_kernels.permute_pairs_lm,
csrc/lookup_sort.cu) on a CUDA tensor, and its plain version,
`permute_pairs_plain`, on the CPU. In the plain version a 256-bit value is
sorted as 8 32-bit words held in int64 by LSD passes of a stable sort, least
significant key first (torch has no multi-key sort) — the same order as the
reference's lexicographic `lax.sort`. The merge is one combined sort of
[S | distinct(A')] with a tag tiebreaker, and the fill is a stable
compaction plus a gather. The permuted columns are committed, so
everything, the `ok` flag of a failing lookup included, is bit-equal to the
reference. Returns an `ok` flag per lookup instead of raising.
"""

from __future__ import annotations

import torch

from . import ff_kernels as FK
from . import limbs as L

_ONES = 0xFFFFFFFF


def _pack_keys(plain):
    """(n, 16) plain limbs -> list of 8 (n,) int64 words, most-significant
    first (lexicographic order == integer order)."""
    p = plain.to(torch.int64)
    words = p[..., 0::2] | (p[..., 1::2] << 16)  # (n, 8) little-endian 32-bit words
    return [words[..., 7 - j] for j in range(8)]


def _unpack_keys(keys):
    """Inverse of _pack_keys: 8 (n,) int64 -> (n, 16) int32 limbs."""
    words = torch.stack(list(keys)[::-1], dim=-1)  # (n, 8) little-endian
    out = torch.stack([words & 0xFFFF, words >> 16], dim=-1)  # (n, 8, 2)
    return out.reshape(out.shape[:-2] + (16,)).to(L.DTYPE)


def _lex_sort(keys):
    """Stable lexicographic sort by keys[0] (most significant) .. keys[-1];
    returns the keys permuted. LSD: stable passes from the least key up."""
    n = keys[0].shape[0]
    order = torch.arange(n, device=keys[0].device)
    for k in reversed(keys):
        order = order.index_select(0, torch.argsort(k.index_select(0, order), stable=True))
    return [k.index_select(0, order) for k in keys]


def _permute_one(a_plain, s_plain):
    """One lookup's permuted pair over the usable rows.

    a_plain, s_plain: (u, 16) plain limbs. Returns (ap, sp, ok):
    (u, 16) plain limbs each, ok scalar bool tensor."""
    u = a_plain.shape[0]
    dev = a_plain.device

    a_sorted = _lex_sort(_pack_keys(a_plain))
    s_sorted = _lex_sort(_pack_keys(s_plain))

    # run starts of A' (first u rows only)
    neq = torch.zeros(u, dtype=torch.bool, device=dev)
    for ka in a_sorted:
        neq[1:] |= ka[1:] != ka[:-1]
    is_start = neq.clone()
    is_start[0] = True

    # distinct values D: A' keys at run starts, sentinel (2^256-1) elsewhere
    d_keys = [torch.where(is_start, ka, _ONES) for ka in a_sorted]

    # merge [S (tag 0) | D (tag 1)]: sort by (value, tag) so each value-run is
    # S-copies then (at most one) D entry
    m_keys = [torch.cat([ks, kd]) for ks, kd in zip(s_sorted, d_keys)]
    tag = torch.cat([torch.zeros(u, dtype=torch.int64, device=dev),
                     torch.ones(u, dtype=torch.int64, device=dev)])
    sorted_m = _lex_sort(m_keys + [tag])
    mk, mtag = sorted_m[:8], sorted_m[8]

    is_d = mtag == 1
    is_sentinel = mk[0] == _ONES
    for k in mk[1:]:
        is_sentinel = is_sentinel & (k == _ONES)
    live_d = is_d & ~is_sentinel

    # a D entry consumes the S copy right before it (same value, tag 0)
    prev_same = torch.ones(2 * u, dtype=torch.bool, device=dev)
    for k in mk:
        prev_same[1:] &= k[1:] == k[:-1]
    prev_same[0] = False
    prev_is_s = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), mtag[:-1] == 0])
    matched = live_d & prev_same & prev_is_s
    ok = torch.all(~live_d | matched)
    consumed = torch.cat([matched[1:], torch.zeros(1, dtype=torch.bool, device=dev)])

    # leftovers: S entries (tag 0) not consumed, in sorted order — stable
    # compaction by a single rank key
    left_mask = (mtag == 0) & ~consumed
    rank_order = torch.argsort((~left_mask).to(torch.int64), stable=True)
    leftover = [k.index_select(0, rank_order) for k in mk]

    # S'[i] = A'[i] at run starts, else next leftover in order
    rank = torch.cumsum((~is_start).to(torch.int64), dim=0) - 1
    rank = torch.clamp(rank, 0, 2 * u - 1)
    sp_keys = [torch.where(is_start, ka, kl.index_select(0, rank))
               for ka, kl in zip(a_sorted, leftover)]
    return _unpack_keys(a_sorted), _unpack_keys(sp_keys), ok


def permute_pairs_device(a_v, s_v, u: int):
    """Batched device permutation for L lookups: a_v, s_v (L, n, 16)
    MONTGOMERY values -> (ap, sp) (L, u, 16) Montgomery + (L,) ok flags.
    Rows past `u` (blinding) are the caller's business. K15 on a CUDA
    tensor (three launches for all the lookups), the plain version on the CPU."""
    return FK.permute_pairs_lm(a_v, s_v, u)


def permute_pairs_plain(a_v, s_v, u: int):
    """K15's plain version: permute_pairs_device's function in plain torch,
    a lookup at a time, with the eager conversions of ops/limbs.py."""
    a_plain = L.from_mont(a_v[:, :u], L.FP)
    s_plain = L.from_mont(s_v[:, :u], L.FP)
    outs = [_permute_one(a_plain[i], s_plain[i]) for i in range(a_v.shape[0])]
    ap = torch.stack([o[0] for o in outs])
    sp = torch.stack([o[1] for o in outs])
    ok = torch.stack([o[2] for o in outs])
    return L.to_mont(ap, L.FP), L.to_mont(sp, L.FP), ok
