"""Batched Poseidon permutation/hash over Fp as limb tensors.

Port of taiga_tpu/ops/poseidon_kernel.py. Witness hashes (commitments,
nullifiers, PRFs), Merkle trees and the encryption sponge reduce to batched
applications of the width-3 P128Pow5T3 permutation.

Layout: a batch of field elements is (N, 16) int32 Montgomery limbs; a state
batch is (N, 3, 16). `permute_batch` is one launch of the hand kernel
csrc/poseidon.cu on a CUDA tensor (all 64 rounds a thread, in registers),
and its plain version (the round loop in torch, limb-major) on a CPU
tensor; FK.plain_versions() forces the plain version on the card. The
sponge (`hash_n_batch`) absorbs with limbs.add and calls the permutation
once per rate block. Bit-exact against taiga_tpu_torch.crypto.poseidon and
taiga_tpu.ops.poseidon_kernel (tests/test_torch_poseidon_kernel.py).
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


@lru_cache(maxsize=None)
def _mont_params():
    """Round constants (64, 3, 16) and MDS (3, 3, 16) in Montgomery limb
    form, numpy int32."""
    r, p = L.FP.r, Fp.MODULUS
    rc = np.stack([L.ints_to_limbs([c * r % p for c in row]) for row in hp.ROUND_CONSTANTS])
    mds = np.stack([L.ints_to_limbs([m * r % p for m in row]) for row in hp.MDS])
    return rc, mds


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
            rc, mds = (_words(a) for a in _mont_params())
            CK.check(so.taiga_poseidon_set_consts(rc.ctypes.data, mds.ctypes.data),
                     "poseidon: set_consts")
            _consts_set = True
    return so


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: the reference's round loop over a
    limb-major copy, the three lanes of a round in one call."""
    rc_np, mds_np = _mont_params()
    dev = state.device
    spec = L.FP
    rc = L.to_lm(L.const(rc_np, dev))  # (16, 64, 3)
    mds = L.to_lm(L.const(mds_np, dev))[:, None]  # (16, 1, 3, 3)
    x = L.to_lm(state)  # (16, N, 3)

    def sbox(v):
        v2 = L.lm_mul(v, v, spec)
        v4 = L.lm_mul(v2, v2, spec)
        return L.lm_mul(v4, v, spec)

    def mix(v):  # row i: m[i][0] s0 + m[i][1] s1 + m[i][2] s2
        t = L.lm_mul(mds, v[:, :, None, :], spec)  # (16, N, 3, 3)
        return L.lm_add(L.lm_add(t[..., 0], t[..., 1], spec), t[..., 2], spec)

    half = hp.FULL_ROUNDS // 2
    for r in range(hp.FULL_ROUNDS + hp.PARTIAL_ROUNDS):
        x = L.lm_add(x, rc[:, r][:, None, :], spec)
        if half <= r < half + hp.PARTIAL_ROUNDS:
            x = torch.cat([sbox(x[..., :1]), x[..., 1:]], dim=-1)
        else:
            x = sbox(x)
        x = mix(x)
    return L.from_lm(x)


def permute_batch(state: torch.Tensor) -> torch.Tensor:
    """(N, 3, 16) Montgomery -> (N, 3, 16) Montgomery: one kernel launch on
    a CUDA tensor, the plain version on a CPU tensor."""
    if state.dtype != L.DTYPE or state.dim() != 3 or state.shape[1:] != (3, L.NLIMBS):
        raise ValueError(f"state: {state.dtype} {tuple(state.shape)}, expected int32 (N, 3, 16)")
    if not FK.use_kernel(state):
        return permute_plain(state)
    state = state.contiguous()
    out = torch.empty_like(state)
    CK.check(_lib().taiga_poseidon_permute(state.data_ptr(), out.data_ptr(), state.shape[0],
                                           CK.stream_ptr(state.device)), "poseidon")
    permute_batch.launches += 1
    return out


permute_batch.launches = 0


def hash_n_batch(message: torch.Tensor, length: int) -> torch.Tensor:
    """Batched ConstantLength<L> hash: message (N, L, 16) Montgomery limbs
    -> (N, 16) Montgomery limbs. Capacity element (L << 64) (Montgomery
    form); the message zero-padded to a multiple of the rate; output
    state[0] after the last permutation (one per rate block)."""
    if message.dim() != 3 or message.shape[1] != length:
        raise ValueError(f"message: shape {tuple(message.shape)}, expected (N, {length}, 16)")
    p = Fp.MODULUS
    cap = L.const(L.int_to_limbs(((length << 64) % p) * L.FP.r % p), message.device)
    zero = torch.zeros_like(message[:, 0])
    state = torch.stack([zero, zero, cap.expand_as(zero)], dim=1)
    for c in range(-(-length // hp.RATE)):
        chunk = [message[:, i] if i < length else zero
                 for i in range(c * hp.RATE, (c + 1) * hp.RATE)]
        state = torch.stack([L.add(state[:, 0], chunk[0], L.FP),
                             L.add(state[:, 1], chunk[1], L.FP), state[:, 2]], dim=1)
        state = permute_batch(state)
    return state[:, 0].contiguous()


def hash2_batch(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Batched Poseidon(left, right): (N, 16), (N, 16) -> (N, 16), Montgomery."""
    return hash_n_batch(torch.stack([left, right], dim=1), 2)


def merkle_level(nodes: torch.Tensor) -> torch.Tensor:
    """One Merkle level: (2M, 16) -> (M, 16), pairing adjacent nodes."""
    return hash2_batch(nodes[0::2], nodes[1::2])


def merkle_root(leaves: torch.Tensor) -> torch.Tensor:
    """Full binary Poseidon Merkle root of a power-of-two batch of leaves:
    (2^d, 16) Montgomery limbs -> (16,) Montgomery limbs."""
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
