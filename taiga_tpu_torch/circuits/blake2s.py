"""In-circuit Blake2s-256 and the resource-logic commitment gadget.

Re-expresses taiga_halo2/src/circuit/blake2s.rs (1220 LoC of
spread/xor plonk gates) on the spread-lookup gadget set (circuits/spread.py):
a 32-bit word is a (dense, spread) cell pair; XOR+rotate costs 2 rows via the
spread-sum even/odd decomposition with rotation-aligned chunks; add mod 2^32
costs 2 rows via byte-pair lookups. One Blake2s compression is ~1.4k rows
(vs ~16k with the previous pure-bit-column design) — this is what lets the
compliance circuit fit a much smaller domain.

Used for:
  * ResourceLogicCommitment in-circuit: Blake2s-256(person="VPCommit",
    logic_vk.to_repr() || rcm.to_repr()) -> two 128-bit limbs
    (blake2s.rs:23-35 resource_logic_commitment_gadget);
  * the compliance circuit's input/output RL commitments
    (compliance_circuit.rs:281-324);
  * publicize_default_dynamic_resource_logic_commitments (blake2s.rs:37-78).

Field decomposition into words includes the canonicity check (the words
encode the UNIQUE little-endian representation < p), mirroring the
reference's field-decomposition soundness: p = 2^254 + T with T < 2^126, so a
256-bit decomposition is canonical iff bit255 = 0 and, when bit254 = 1, bits
126..253 are zero and the low 126 bits are <= T - 1 (borrow witness).
"""

from __future__ import annotations

from ..crypto.fields import Fp
from ..plonk.circuit import CircuitBuilder
from . import gadgets as G
from . import spread as S
from .spread import SpreadWord

P = Fp.MODULUS
MASK32 = 0xFFFFFFFF

IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]

SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]

# kept for compatibility with callers that treat words generically
Word = SpreadWord


def g_mix(b: CircuitBuilder, v, a, bb, c, d, x: SpreadWord, y: SpreadWord):
    """The Blake2s G function on state list v (indices a,bb,c,d)."""
    v[a] = S.add32(b, [v[a], v[bb], x])
    v[d] = S.xor_rot(b, v[d], v[a], 16)
    v[c] = S.add32(b, [v[c], v[d]])
    v[bb] = S.xor_rot(b, v[bb], v[c], 12)
    v[a] = S.add32(b, [v[a], v[bb], y])
    v[d] = S.xor_rot(b, v[d], v[a], 8)
    v[c] = S.add32(b, [v[c], v[d]])
    v[bb] = S.xor_rot(b, v[bb], v[c], 7)


def compress(b: CircuitBuilder, h: list[SpreadWord], m: list[SpreadWord],
             t: int, last: bool) -> list[SpreadWord]:
    """One Blake2s compression (10 rounds). h may contain constant words."""
    v = list(h) + [SpreadWord(const=IV[i]) for i in range(8)]
    v[12] = S.xor_rot(b, v[12], SpreadWord(const=t & MASK32), 0)
    v[13] = S.xor_rot(b, v[13], SpreadWord(const=(t >> 32) & MASK32), 0)
    if last:
        v[14] = S.xor_rot(b, v[14], SpreadWord(const=MASK32), 0)
    for r in range(10):
        s = SIGMA[r]
        g_mix(b, v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        g_mix(b, v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        g_mix(b, v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        g_mix(b, v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        g_mix(b, v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        g_mix(b, v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        g_mix(b, v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        g_mix(b, v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    return [
        S.xor_rot(b, S.xor_rot(b, v[i], v[i + 8], 0), h[i], 0)
        for i in range(8)
    ]


# --- field element <-> words -------------------------------------------------

# p = 2^254 + T_LOW, T_LOW < 2^126
T_LOW = P - (1 << 254)
assert T_LOW < (1 << 126)


def _split_top_bits(b: CircuitBuilder, word: SpreadWord, lo_bits: int):
    """Split a 32-bit word cell into (lo, bit_{lo_bits}, bit_{lo_bits+1});
    lo range-checked via lookups, bits boolean. Returns (lo, b_lo, b_hi)."""
    assert lo_bits == 30
    v = word.value
    lo_v = None if v is None else v & ((1 << 30) - 1)
    b0_v = None if v is None else (v >> 30) & 1
    b1_v = None if v is None else (v >> 31) & 1
    lo = G.witness_cell(b, lo_v)
    S.lookup_range_check(b, lo, 30)
    b0 = G.witness_cell(b, b0_v)
    b1 = G.witness_cell(b, b1_v)
    G.is_bool(b, b0)
    G.is_bool(b, b1)
    acc = G.add_scaled(b, lo, b0, 1 << 30)
    acc = G.add_scaled(b, acc, b1, 1 << 31)
    G.assert_equal(b, acc, word.dense)
    return lo, b0, b1


def field_to_words(b: CircuitBuilder, cell) -> list[SpreadWord]:
    """Decompose a field cell into 8 little-endian 32-bit spread words with
    the canonicity (< p) check. ~75 rows (was ~90 with bit columns)."""
    v = cell.value
    words = [
        S.witness_spread_word(b, None if v is None else (v >> (32 * j)) & MASK32)
        for j in range(8)
    ]
    # recomposition: cell == sum words[j] * 2^(32 j)
    acc = words[0].dense
    for j in range(1, 8):
        acc = G.add_scaled(b, acc, words[j].dense, 1 << (32 * j))
    G.assert_equal(b, acc, cell)

    # canonicity: b255 == 0; if b254 == 1 then bits 126..253 all zero and
    # low 126 bits <= T_LOW - 1 (borrow witness range-checked to 126 bits).
    lo7, b254, b255 = _split_top_bits(b, words[7], 30)
    G.assert_equal_constant(b, b255, 0)
    hi = b254
    # words 4..6 zero when hi: hi * w_j == 0
    for j in (4, 5, 6):
        z = G.mul_cells(b, hi, words[j].dense)
        G.assert_equal_constant(b, z, 0)
    # w7 low 30 bits zero when hi
    z = G.mul_cells(b, hi, lo7)
    G.assert_equal_constant(b, z, 0)
    # w3 top two bits (bits 126,127) zero when hi
    _, w3b30, w3b31 = _split_top_bits(b, words[3], 30)
    t2 = G.add_scaled(b, w3b30, w3b31, 2)
    z = G.mul_cells(b, hi, t2)
    G.assert_equal_constant(b, z, 0)
    # borrow check: d = hi * (T_LOW - 1 - lo126); lo126 = w0..w3 combined.
    lo = words[0].dense
    for j in (1, 2, 3):
        lo = G.add_scaled(b, lo, words[j].dense, 1 << (32 * j))
    # t = T_LOW - 1 - lo
    tv = None if lo.value is None else (T_LOW - 1 - lo.value) % P
    ca, _, tcell = G.assign_vanilla(b, ql=P - 1, qc=(T_LOW - 1) % P, qo=P - 1,
                                    va=lo.value, vc=tv)
    b.copy(ca, lo)
    d = G.mul_cells(b, hi, tcell)
    S.lookup_range_check(b, d, 126)
    return words


def words_to_u128_cell(b: CircuitBuilder, words: list[SpreadWord]):
    """Combine 4 words (LE) into one field cell (a 128-bit limb)."""
    cache = S._cache(b)
    acc = words[0].dense_cell(b, cache)
    for j in range(1, 4):
        acc = G.add_scaled(b, acc, words[j].dense_cell(b, cache), 1 << (32 * j))
    return acc


# --- the resource-logic commitment gadget -----------------------------------

# Blake2s parameter block word 0: digest_length=32, key=0, fanout=1, depth=1
_PARAM_W0 = 32 | (1 << 16) | (1 << 24)


def _personal_words(person: bytes) -> tuple[int, int]:
    person = person.ljust(8, b"\0")
    return (
        int.from_bytes(person[0:4], "little"),
        int.from_bytes(person[4:8], "little"),
    )


def blake2s_init_words(person: bytes) -> list[SpreadWord]:
    p6, p7 = _personal_words(person)
    h = [SpreadWord(const=IV[i]) for i in range(8)]
    h[0] = SpreadWord(const=IV[0] ^ _PARAM_W0)
    h[6] = SpreadWord(const=IV[6] ^ p6)
    h[7] = SpreadWord(const=IV[7] ^ p7)
    return h


def resource_logic_commitment_gadget(b: CircuitBuilder, logic_cell, rcm_cell,
                                     one_cell=None):
    """In-circuit ResourceLogicCommitment (resource_logic_commitment.rs:16-46
    semantics): Blake2s-256("VPCommit", logic.to_repr() || rcm.to_repr()),
    output as two 128-bit field limbs (lo, hi)."""
    h = blake2s_init_words(b"VPCommit")
    m = field_to_words(b, logic_cell) + field_to_words(b, rcm_cell)
    out = compress(b, h, m, t=64, last=True)
    lo = words_to_u128_cell(b, out[0:4])
    hi = words_to_u128_cell(b, out[4:8])
    return lo, hi
