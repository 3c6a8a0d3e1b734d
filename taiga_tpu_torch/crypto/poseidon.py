"""Poseidon permutation & sponge over the Pallas base field (P128Pow5T3).

Parameters match `halo2_gadgets::poseidon::primitives::P128Pow5T3` as used by
the reference (t = 3, rate = 2, x^5 S-box, 8 full + 56 partial rounds; see
taiga_halo2/src/utils.rs:40-48 and src/constant.rs:99-100).

Round constants and the MDS matrix are generated with the Grain LFSR procedure
from the Poseidon reference implementation (as re-implemented in
halo2_gadgets `poseidon/primitives/grain.rs` + `mds.rs`):
  * 80-bit LFSR seeded with (field-type=1, sbox=0(pow), n=255, t, R_F, R_P, 1...1),
    taps b[i+80] = b[i+62]^b[i+51]^b[i+38]^b[i+23]^b[i+13]^b[i],
    first 160 output bits discarded, then self-decimated in bit pairs
    (emit the second bit of a pair iff the first bit is 1);
  * round constants: 255 bits MSB-first, wide-reduced mod p (no rejection);
  * MDS: Cauchy matrix 1/(x_i + y_j) from 2t rejection-sampled unique elements.

Constants are generated once at import (fast: ~64*3 + 6 samples) and cached.

The batched TPU kernel in `taiga_tpu.ops.poseidon_kernel` is differentially
tested against this implementation.
"""

from __future__ import annotations

from functools import lru_cache

from .fields import Fp

T = 3  # state width
RATE = 2
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 56
ALPHA = 5


class _Grain:
    """Grain LFSR stream used by the Poseidon reference constant generation."""

    def __init__(self, t: int, r_f: int, r_p: int, num_bits: int = 255):
        state = [1] * 80

        def set_bits(offset, length, value):
            # Initial state bits are set MSB-first within each field.
            for i in range(length):
                state[offset + length - 1 - i] = (value >> i) & 1

        set_bits(0, 2, 1)  # field type: prime field
        set_bits(2, 4, 0)  # sbox: x^alpha
        set_bits(6, 12, num_bits)
        set_bits(18, 12, t)
        set_bits(30, 10, r_f)
        set_bits(40, 10, r_p)
        self.state = state
        self.num_bits = num_bits
        # discard the first 160 bits
        for _ in range(160):
            self._clock()

    def _clock(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        del s[0]
        s.append(new)
        return new

    def _next_bit(self) -> int:
        # Self-decimation: evaluate bits in pairs; if the first bit is 1,
        # output the second; otherwise discard the second.
        while True:
            if self._clock():
                return self._clock()
            self._clock()

    def _next_int(self) -> int:
        v = 0
        for _ in range(self.num_bits):
            v = (v << 1) | self._next_bit()  # MSB first
        return v

    def next_field_element_without_rejection(self) -> int:
        return self._next_int() % Fp.MODULUS

    def next_field_element(self) -> int:
        while True:
            v = self._next_int()
            if v < Fp.MODULUS:
                return v


@lru_cache(maxsize=None)
def generate_constants(t: int = T, r_f: int = FULL_ROUNDS, r_p: int = PARTIAL_ROUNDS):
    """Returns (round_constants [(r_f+r_p) x t], mds [t x t], mds_inv) as ints."""
    grain = _Grain(t, r_f, r_p)
    round_constants = [
        [grain.next_field_element_without_rejection() for _ in range(t)]
        for _ in range(r_f + r_p)
    ]
    # MDS: sample 2t unique elements with rejection; Cauchy matrix.
    while True:
        vals = [grain.next_field_element() for _ in range(2 * t)]
        if len(set(vals)) == 2 * t:
            xs, ys = vals[:t], vals[t:]
            break
    p = Fp.MODULUS
    mds = [[pow(xs[i] + ys[j], -1, p) for j in range(t)] for i in range(t)]
    mds_inv = _invert_matrix(mds, p)
    return round_constants, mds, mds_inv


def _invert_matrix(m, p):
    n = len(m)
    aug = [[m[i][j] % p for j in range(n)] + [1 if i == j else 0 for j in range(n)] for i in range(n)]
    for col in range(n):
        piv = next(r for r in range(col, n) if aug[r][col] % p != 0)
        aug[col], aug[piv] = aug[piv], aug[col]
        inv = pow(aug[col][col], -1, p)
        aug[col] = [x * inv % p for x in aug[col]]
        for r in range(n):
            if r != col and aug[r][col]:
                f = aug[r][col]
                aug[r] = [(a - f * b) % p for a, b in zip(aug[r], aug[col])]
    return [row[n:] for row in aug]


# Module-level cached parameters (ints, not Fp, for speed).
ROUND_CONSTANTS, MDS, MDS_INV = generate_constants()
_P = Fp.MODULUS


def permute_ints(state: list[int]) -> list[int]:
    """Poseidon permutation on a width-3 state of plain ints (mod p).

    Mirrors halo2_gadgets `primitives::permute`: first half full rounds,
    partial rounds (S-box on state[0] only), second half full rounds. Round
    constants are added to the whole state at the start of every round.

    Dispatches to the native C++ engine (taiga_tpu.native) when available;
    the Python path below is the differential reference.
    """
    from .. import native as _native

    out = _native.poseidon_permute_ints(state)
    if out is not None:
        return out
    p = _P
    s0, s1, s2 = state
    m = MDS
    half = FULL_ROUNDS // 2
    r = 0
    for _ in range(half):
        rc = ROUND_CONSTANTS[r]
        s0 = pow((s0 + rc[0]) % p, ALPHA, p)
        s1 = pow((s1 + rc[1]) % p, ALPHA, p)
        s2 = pow((s2 + rc[2]) % p, ALPHA, p)
        s0, s1, s2 = (
            (m[0][0] * s0 + m[0][1] * s1 + m[0][2] * s2) % p,
            (m[1][0] * s0 + m[1][1] * s1 + m[1][2] * s2) % p,
            (m[2][0] * s0 + m[2][1] * s1 + m[2][2] * s2) % p,
        )
        r += 1
    for _ in range(PARTIAL_ROUNDS):
        rc = ROUND_CONSTANTS[r]
        s0 = pow((s0 + rc[0]) % p, ALPHA, p)
        s1 = (s1 + rc[1]) % p
        s2 = (s2 + rc[2]) % p
        s0, s1, s2 = (
            (m[0][0] * s0 + m[0][1] * s1 + m[0][2] * s2) % p,
            (m[1][0] * s0 + m[1][1] * s1 + m[1][2] * s2) % p,
            (m[2][0] * s0 + m[2][1] * s1 + m[2][2] * s2) % p,
        )
        r += 1
    for _ in range(half):
        rc = ROUND_CONSTANTS[r]
        s0 = pow((s0 + rc[0]) % p, ALPHA, p)
        s1 = pow((s1 + rc[1]) % p, ALPHA, p)
        s2 = pow((s2 + rc[2]) % p, ALPHA, p)
        s0, s1, s2 = (
            (m[0][0] * s0 + m[0][1] * s1 + m[0][2] * s2) % p,
            (m[1][0] * s0 + m[1][1] * s1 + m[1][2] * s2) % p,
            (m[2][0] * s0 + m[2][1] * s1 + m[2][2] * s2) % p,
        )
        r += 1
    return [s0, s1, s2]


def permute(state: list[Fp]) -> list[Fp]:
    return [Fp(v) for v in permute_ints([s.v for s in state])]


def _hash_ints(message: list[int], length: int) -> int:
    """ConstantLength<L> sponge hash -> first rate element.

    halo2_gadgets semantics: capacity element initialised to (L << 64) as u128,
    message zero-padded to a multiple of the rate; for each rate-sized chunk the
    chunk is added into state[0..RATE] and the state permuted; output state[0].
    """
    assert len(message) == length
    state = [0, 0, (length << 64) % _P]
    padded = list(message)
    k = -(-length // RATE)  # ceil
    padded += [0] * (k * RATE - length)
    for i in range(0, len(padded), RATE):
        state[0] = (state[0] + padded[i]) % _P
        state[1] = (state[1] + padded[i + 1]) % _P
        state = permute_ints(state)
    return state[0]


def poseidon_hash(left: Fp, right: Fp) -> Fp:
    """Poseidon ConstantLength<2> hash (reference utils.rs:40-43)."""
    return Fp(_hash_ints([left.v, right.v], 2))


def poseidon_hash_n(message: list[Fp]) -> Fp:
    """Poseidon ConstantLength<L> hash (reference utils.rs:45-48)."""
    return Fp(_hash_ints([m.v for m in message], len(message)))


def prf_nf(nk: Fp, nonce: Fp) -> Fp:
    """PRF^nf(nk, nonce) = Poseidon(nk, nonce) (reference utils.rs:36-38)."""
    return poseidon_hash(nk, nonce)


class PoseidonSponge:
    """Duplex-style sponge with an explicit initial state, used by resource
    encryption (reference src/resource_encryption.rs:97-113)."""

    def __init__(self, initial_state: list[Fp]):
        assert len(initial_state) == T
        self.state = [s.v for s in initial_state]

    def permute(self):
        self.state = permute_ints(self.state)

    def state_fp(self) -> list[Fp]:
        return [Fp(v) for v in self.state]
