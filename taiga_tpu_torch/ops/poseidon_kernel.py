"""Batched Poseidon permutation/hash over Fp as limb tensors.

Port of taiga_tpu/ops/poseidon_kernel.py. Witness hashes (commitments,
nullifiers, PRFs), Merkle trees and the encryption sponge reduce to batched
applications of the width-3 P128Pow5T3 permutation.

Layout: a batch of field elements is (N, 16) int32 Montgomery limbs; a state
batch is (N, 3, 16). Two entry points of the hand kernel csrc/poseidon.cu:
`permute_batch` (one launch a batch of states) and `hash_n_batch` (the whole
ConstantLength<L> sponge, every rate block absorbed and permuted in
registers: one launch for any L); `merkle_level` is the sponge over the
(2M, 16) nodes read as (M, 2, 16), so `merkle_root` is one launch a level.
Both run the permutation in the sparse form of Grassi et al. ("Poseidon: A
New Hash Function for Zero-Knowledge Proof Systems", USENIX Security 2021,
Appendix B): 592 Montgomery products a state instead of 816. On a CPU
tensor each runs its plain version (the same arithmetic in torch,
limb-major); FK.plain_versions() forces the plain versions on the card.
Field arithmetic is exact, so the limbs equal taiga_tpu_torch.crypto.
poseidon's and taiga_tpu.ops.poseidon_kernel's
(tests/test_torch_poseidon_kernel.py).
"""

from __future__ import annotations

import threading
from functools import lru_cache

import numpy as np
import torch

from ..crypto import poseidon as hp
from ..crypto.fields import Fp
from . import cuda_kernels as CK
from . import ff_kernels as FK
from . import limbs as L

HALF = hp.FULL_ROUNDS // 2


def _matmul(a, b, p):
    return [[sum(a[i][k] * b[k][j] for k in range(3)) % p for j in range(3)] for i in range(3)]


@lru_cache(maxsize=None)
def sparse_params():
    """The permutation's constants in the sparse form, ints mod p, derived
    in exact Fp arithmetic from crypto/poseidon.py's ROUND_CONSTANTS and MDS:

    1. A partial round adds its constants and applies the S-box to lane 0
       only, so the constants of lanes 1-2 pass the S-box unchanged and go
       through the MDS M into the next round: round r + 1's constants
       become c_{r+1} + M (0, c_r1, c_r2). A partial round then adds one
       constant (k, lane 0); the first full round after them carries the
       rest.
    2. From the last partial round back, its matrix N (M, then D M) is
       factored as N = S D, D = diag(1, N11..22), S = [[n00, b], [w, I]]
       with b = (n01, n02) (N11..22)^-1 and w = (n10, n20). D leaves lane 0
       alone, so it commutes with the partial round's constant and S-box
       and moves into the round before; the last full round before the
       partial rounds takes the dense `first` = D M. S costs 5 products:
       x0' = n00 x0 + b1 x1 + b2 x2, x1' = w1 x0 + x1, x2' = w2 x0 + x2.
    3. n00 = M00 = a in every round, and the kernel computes a x0^5 as
       (a u) (u^2)^2 with u = x0 + k (3 products on lane 0's chain, not
       4), so w is kept as w / a: x1' = (w1 / a) (a x0^5) + x1.

    Returns dict(full=(FULL_ROUNDS, 3) constants, mds, first (3 x 3),
    a, partial=(PARTIAL_ROUNDS, 5) rows (k, b1, b2, w1 / a, w2 / a))."""
    p = Fp.MODULUS
    M = hp.MDS
    rc = [list(r) for r in hp.ROUND_CONSTANTS]
    for r in range(HALF, HALF + hp.PARTIAL_ROUNDS):
        c1, c2 = rc[r][1], rc[r][2]
        rc[r + 1] = [(rc[r + 1][i] + M[i][1] * c1 + M[i][2] * c2) % p for i in range(3)]
    a = M[0][0]
    a_inv = pow(a, p - 2, p)
    partial = [None] * hp.PARTIAL_ROUNDS
    N = M
    for j in reversed(range(hp.PARTIAL_ROUNDS)):
        (n11, n12), (n21, n22) = N[1][1:], N[2][1:]
        det_inv = pow((n11 * n22 - n12 * n21) % p, p - 2, p)
        b1 = (N[0][1] * n22 - N[0][2] * n21) * det_inv % p
        b2 = (N[0][2] * n11 - N[0][1] * n12) * det_inv % p
        if N[0][0] != a:
            raise AssertionError("the sparse factors' n00 is not M00")
        partial[j] = (rc[HALF + j][0], b1, b2, N[1][0] * a_inv % p, N[2][0] * a_inv % p)
        N = _matmul([[1, 0, 0], [0, n11, n12], [0, n21, n22]], M, p)
    full = rc[:HALF] + rc[HALF + hp.PARTIAL_ROUNDS:]
    return dict(full=full, mds=M, first=N, a=a, partial=partial)


def permute_sparse_ints(state: list[int]) -> list[int]:
    """The sparse form on the host, one state of ints mod p: the kernel's
    arithmetic, the oracle of the constants (equal to crypto/poseidon.py's
    permute_ints)."""
    p = Fp.MODULUS
    sp = sparse_params()
    s = [v % p for v in state]

    def full_round(s, i):
        m = sp["first"] if i == HALF - 1 else sp["mds"]
        s = [pow((v + c) % p, hp.ALPHA, p) for v, c in zip(s, sp["full"][i])]
        return [sum(m[r][j] * s[j] for j in range(3)) % p for r in range(3)]

    for i in range(HALF):
        s = full_round(s, i)
    a = sp["a"]
    for k, b1, b2, w1, w2 in sp["partial"]:
        u = (s[0] + k) % p
        v = a * u % p * pow(u, 4, p) % p  # a u^5
        s = [(v + b1 * s[1] + b2 * s[2]) % p, (w1 * v + s[1]) % p, (w2 * v + s[2]) % p]
    for i in range(HALF, hp.FULL_ROUNDS):
        s = full_round(s, i)
    return s


@lru_cache(maxsize=None)
def _mont_params():
    """The sparse form's constants in Montgomery limb form, numpy int32:
    full (8, 3, 16), mds (3, 3, 16), first (3, 3, 16), a (16,), partial
    (56, 5, 16), and R^2 mod p (16,) (the sponge's capacity element is
    built from it in the kernel)."""
    r, p = L.FP.r, Fp.MODULUS
    sp = sparse_params()
    mont = lambda rows: np.stack([L.ints_to_limbs([c * r % p for c in row]) for row in rows])
    return dict(full=mont(sp["full"]), mds=mont(sp["mds"]), first=mont(sp["first"]),
                a=L.int_to_limbs(sp["a"] * r % p), partial=mont(sp["partial"]),
                r2=L.int_to_limbs(L.FP.r2))


def _words(limbs: np.ndarray) -> np.ndarray:
    """(..., 16) 16-bit limbs -> (..., 8) uint32 words, little-endian."""
    lm = limbs.astype(np.uint32)
    return np.ascontiguousarray(lm[..., 0::2] | (lm[..., 1::2] << 16))


_consts_lock = threading.Lock()
_consts_set = False


def _lib():
    """The kernel's library, its constants filled once a process."""
    global _consts_set
    so = CK.lib("poseidon")
    with _consts_lock:
        if not _consts_set:
            mp = _mont_params()
            w = {k: _words(v) for k, v in mp.items()}
            CK.check(so.taiga_poseidon_set_consts(*(w[k].ctypes.data for k in (
                "full", "mds", "first", "a", "partial", "r2"))), "poseidon: set_consts")
            _consts_set = True
    return so


def _lm_consts(dev):
    """The constants as limb-major int32 tensors on `dev`."""
    return {k: L.to_lm(L.const(v, dev)) for k, v in _mont_params().items()}


def _permute_lm(x0, x1, x2, c):
    """Plain version of the kernel's permutation over limb-major (16, N)
    lanes, with its arithmetic: full rounds with the dense matrices, then
    the sparse partial rounds in the kernel's three product stages
    (u u and a u; (u^2)^2, b1 x1 and b2 x2; v = (a u) u^4), then the full
    rounds. Each stage's products are one call."""
    spec = L.FP

    def mul(lhs, rhs):  # several products in one call
        n = x0.shape[1]
        lhs = torch.stack([t.expand(16, n) for t in lhs], 1)
        rhs = torch.stack([t.expand(16, n) for t in rhs], 1)
        return L.lm_mul(lhs, rhs, spec).unbind(1)

    def full_round(s, i):
        m = c["first"] if i == HALF - 1 else c["mds"]  # (16, 3, 3)
        s = [L.lm_add(v, c["full"][:, i, j, None], spec) for j, v in enumerate(s)]
        s2 = mul(s, s)
        s4 = mul(s2, s2)
        s = mul(s4, s)
        t = mul([m[:, r, j, None] for r in range(3) for j in range(3)], s * 3)
        return [L.lm_add(L.lm_add(t[3 * r], t[3 * r + 1], spec), t[3 * r + 2], spec)
                for r in range(3)]

    s = [x0, x1, x2]
    for i in range(HALF):
        s = full_round(s, i)
    a = c["a"][:, None]
    for j in range(hp.PARTIAL_ROUNDS):
        k, b1, b2, w1, w2 = (c["partial"][:, j, e, None] for e in range(5))
        u = L.lm_add(s[0], k, spec)
        u2, au = mul([u, a], [u, u])
        u4, q1, q2 = mul([u2, b1, b2], [u2, s[1], s[2]])
        (v,) = mul([au], [u4])
        r1, r2 = mul([w1, w2], [v, v])
        s = [L.lm_add(L.lm_add(v, q1, spec), q2, spec), L.lm_add(r1, s[1], spec),
             L.lm_add(r2, s[2], spec)]
    for i in range(HALF, hp.FULL_ROUNDS):
        s = full_round(s, i)
    return s


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """Plain version of the permutation kernel: (N, 3, 16) -> (N, 3, 16)."""
    x = L.to_lm(state)  # (16, N, 3)
    out = _permute_lm(x[..., 0], x[..., 1], x[..., 2], _lm_consts(state.device))
    return L.from_lm(torch.stack(out, -1))


def _check_state(state):
    if state.dtype != L.DTYPE or state.dim() != 3 or state.shape[1:] != (3, L.NLIMBS):
        raise ValueError(f"state: {state.dtype} {tuple(state.shape)}, expected int32 (N, 3, 16)")


def permute_batch(state: torch.Tensor) -> torch.Tensor:
    """(N, 3, 16) Montgomery -> (N, 3, 16) Montgomery: one kernel launch on
    a CUDA tensor, the plain version on a CPU tensor."""
    _check_state(state)
    if not FK.use_kernel(state):
        return permute_plain(state)
    state = state.contiguous()
    out = torch.empty_like(state)
    CK.check(_lib().taiga_poseidon_permute(state.data_ptr(), out.data_ptr(), state.shape[0],
                                           CK.stream_ptr(state.device)), "poseidon")
    permute_batch.launches += 1
    return out


permute_batch.launches = 0


def _capacity(length: int, device) -> torch.Tensor:
    """The ConstantLength<L> capacity element (L << 64), Montgomery (16,)."""
    p = Fp.MODULUS
    return L.const(L.int_to_limbs(((length << 64) % p) * L.FP.r % p), device)


def hash_n_plain(message: torch.Tensor, length: int) -> torch.Tensor:
    """Plain version of the sponge kernel: the rate blocks absorbed into
    lanes 0-1 (zero-padded) with limbs.add, each followed by the plain
    permutation."""
    zero = torch.zeros_like(message[:, 0])
    state = torch.stack([zero, zero, _capacity(length, message.device).expand_as(zero)], dim=1)
    for c in range(-(-length // hp.RATE)):
        chunk = [message[:, i] if i < length else zero
                 for i in range(c * hp.RATE, (c + 1) * hp.RATE)]
        state = torch.stack([L.add(state[:, 0], chunk[0], L.FP),
                             L.add(state[:, 1], chunk[1], L.FP), state[:, 2]], dim=1)
        state = permute_plain(state)
    return state[:, 0].contiguous()


def hash_n_batch(message: torch.Tensor, length: int) -> torch.Tensor:
    """Batched ConstantLength<L> hash: message (N, L, 16) Montgomery limbs
    -> (N, 16) Montgomery limbs. Capacity element (L << 64) (Montgomery
    form); the message zero-padded to a multiple of the rate; output
    state[0] after the last permutation (one per rate block). One launch of
    the sponge kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if (message.dtype != L.DTYPE or message.dim() != 3 or message.shape[1] != length
            or message.shape[2] != L.NLIMBS or not 1 <= length < 1 << 31):
        raise ValueError(f"message: {message.dtype} {tuple(message.shape)}, expected int32 "
                         f"(N, {length}, 16)")
    if not FK.use_kernel(message):
        return hash_n_plain(message, length)
    message = message.contiguous()
    out = torch.empty((message.shape[0], L.NLIMBS), dtype=L.DTYPE, device=message.device)
    CK.check(_lib().taiga_poseidon_sponge(message.data_ptr(), out.data_ptr(), message.shape[0],
                                          length, CK.stream_ptr(message.device)),
             "poseidon_sponge")
    hash_n_batch.launches += 1
    return out


hash_n_batch.launches = 0


def hash2_batch(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Batched Poseidon(left, right): (N, 16), (N, 16) -> (N, 16), Montgomery."""
    return hash_n_batch(torch.stack([left, right], dim=1), 2)


def merkle_level(nodes: torch.Tensor) -> torch.Tensor:
    """One Merkle level: (2M, 16) -> (M, 16), pairing adjacent nodes: the
    sponge over the nodes read as (M, 2, 16) pairs, no copy."""
    if nodes.dim() != 2 or nodes.shape[0] % 2:
        raise ValueError(f"nodes: shape {tuple(nodes.shape)}, expected (2M, 16)")
    return hash_n_batch(nodes.contiguous().view(-1, 2, L.NLIMBS), 2)


def merkle_root(leaves: torch.Tensor) -> torch.Tensor:
    """Full binary Poseidon Merkle root of a power-of-two batch of leaves:
    (2^d, 16) Montgomery limbs -> (16,) Montgomery limbs; one sponge launch
    a level on a CUDA tensor."""
    n = leaves.shape[0]
    if n < 1 or n & (n - 1):
        raise ValueError(f"{n} leaves: need a power of two")
    nodes = leaves
    while nodes.shape[0] > 1:
        nodes = merkle_level(nodes)
    return nodes[0]


# --- host conversion helpers ------------------------------------------------


def fps_to_mont(values) -> np.ndarray:
    """[Fp] -> (N, 16) Montgomery limb array."""
    return L.FP.array_to_mont([v.v for v in values])


def mont_to_fps(arr) -> list[Fp]:
    """(N, 16) Montgomery limbs (numpy or a tensor) -> [Fp]."""
    return [Fp(v) for v in L.FP.array_from_mont(arr)]
