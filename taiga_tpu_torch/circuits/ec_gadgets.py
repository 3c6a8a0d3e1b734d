"""In-circuit Pallas elliptic-curve gadgets (shared by the compliance circuit
and the resource-logic examples).

Mirrors the used surface of halo2_gadgets' EccChip (reference
taiga_halo2/src/circuit/integrity.rs:546-630 delta commitment,
resource_logic_examples/signature_verification.rs Schnorr verification,
resource_encryption_circuit.rs DH): witnessed non-identity points with an
on-curve check, one-row incomplete add/double gates, and blinded double-and-
add scalar multiplication over little-endian bit cells.
"""

from __future__ import annotations

from ..crypto.curves import PallasPoint
from ..crypto.fields import Fp
from ..plonk.circuit import CircuitBuilder
from . import gadgets as G

P = Fp.MODULUS


class PointCells:
    """An affine Pallas point as two advice cells."""

    __slots__ = ("x", "y")

    def __init__(self, x, y):
        self.x = x
        self.y = y


def witness_point(b: CircuitBuilder, point: PallasPoint | None) -> PointCells:
    """Witness a non-identity affine point with the on-curve constraint
    y^2 = x^3 + 5 (the reference's NonIdentityPoint::new)."""
    xv = None if point is None else point.x.v
    yv = None if point is None else point.y.v
    x = G.witness_cell(b, xv)
    y = G.witness_cell(b, yv)
    x2 = G.mul_cells(b, x, x)
    x3 = G.mul_cells(b, x2, x)
    y2 = G.mul_cells(b, y, y)
    d = G.sub_cells(b, y2, x3)
    G.assert_equal_constant(b, d, 5)
    return PointCells(x, y)


def constant_point(b: CircuitBuilder, point: PallasPoint) -> PointCells:
    return PointCells(
        G.constant_cell(b, point.x.v), G.constant_cell(b, point.y.v)
    )


def ec_add_gadget(b: CircuitBuilder, p1: PointCells, p2: PointCells) -> PointCells:
    """Incomplete affine addition (one row). Caller must ensure x1 != x2."""
    row = b.alloc_rows(1)
    b.assign_fixed(G.Q_EC_ADD, row, 1)
    known = p1.x.value is not None and p2.x.value is not None
    if known:
        x1, y1, x2, y2 = p1.x.value, p1.y.value, p2.x.value, p2.y.value
        assert x1 != x2, "incomplete add degeneracy"
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
        x3 = (lam * lam - x1 - x2) % P
        y3 = (lam * (x1 - x3) - y1) % P
    else:
        lam = x3 = y3 = None
    cx1 = b.assign_advice(0, row, p1.x.value)
    cy1 = b.assign_advice(1, row, p1.y.value)
    cx2 = b.assign_advice(2, row, p2.x.value)
    cy2 = b.assign_advice(3, row, p2.y.value)
    b.assign_advice(4, row, lam)
    cx3 = b.assign_advice(5, row, x3)
    cy3 = b.assign_advice(6, row, y3)
    b.copy(cx1, p1.x)
    b.copy(cy1, p1.y)
    b.copy(cx2, p2.x)
    b.copy(cy2, p2.y)
    return PointCells(cx3, cy3)


def ec_dbl_gadget(b: CircuitBuilder, p: PointCells) -> PointCells:
    row = b.alloc_rows(1)
    b.assign_fixed(G.Q_EC_DBL, row, 1)
    if p.x.value is not None:
        x1, y1 = p.x.value, p.y.value
        lam = 3 * x1 * x1 % P * pow(2 * y1 % P, -1, P) % P
        x3 = (lam * lam - 2 * x1) % P
        y3 = (lam * (x1 - x3) - y1) % P
    else:
        lam = x3 = y3 = None
    cx1 = b.assign_advice(0, row, p.x.value)
    cy1 = b.assign_advice(1, row, p.y.value)
    b.assign_advice(2, row, lam)
    cx3 = b.assign_advice(3, row, x3)
    cy3 = b.assign_advice(4, row, y3)
    b.copy(cx1, p.x)
    b.copy(cy1, p.y)
    return PointCells(cx3, cy3)


def ec_select_gadget(b: CircuitBuilder, flag, p: PointCells, q: PointCells) -> PointCells:
    return PointCells(
        G.select_cell(b, flag, p.x, q.x), G.select_cell(b, flag, p.y, q.y)
    )


def ec_cond_add_gadget(b: CircuitBuilder, acc: PointCells, point: PointCells,
                       bit) -> PointCells:
    """acc + bit*P in ONE row (Q_EC_SEL_ADD). bit must already be boolean-
    constrained. Incomplete: caller ensures acc.x != point.x when bit = 1."""
    row = b.alloc_rows(1)
    b.assign_fixed(G.Q_EC_SEL_ADD, row, 1)
    known = acc.x.value is not None and point.x.value is not None and bit.value is not None
    if known:
        x1, y1, x2, y2 = acc.x.value, acc.y.value, point.x.value, point.y.value
        if bit.value:
            assert x1 != x2, "incomplete cond-add degeneracy"
            lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
            x3 = (lam * lam - x1 - x2) % P
            y3 = (lam * (x1 - x3) - y1) % P
        else:
            lam, x3, y3 = 0, x1, y1
    else:
        lam = x3 = y3 = None
    cx1 = b.assign_advice(0, row, acc.x.value)
    cy1 = b.assign_advice(1, row, acc.y.value)
    cx2 = b.assign_advice(2, row, point.x.value)
    cy2 = b.assign_advice(3, row, point.y.value)
    b.assign_advice(4, row, lam)
    cx3 = b.assign_advice(5, row, x3)
    cy3 = b.assign_advice(6, row, y3)
    cbit = b.assign_advice(7, row, bit.value)
    b.copy(cx1, acc.x)
    b.copy(cy1, acc.y)
    b.copy(cx2, point.x)
    b.copy(cy2, point.y)
    b.copy(cbit, bit)
    return PointCells(cx3, cy3)


def ec_multi_scalar_mul_gadget(
    b: CircuitBuilder, terms, blind: PallasPoint
) -> PointCells:
    """sum_i [s_i] B_i via ONE blinded simultaneous double-and-add.

    terms: list of (PointCells, little-endian bit cells). The accumulator
    starts at the blinding base T and ends subtracting [2^max_len]T, so no
    intermediate incomplete add degenerates (w.h.p. — T is a hash-to-curve
    point with unknown discrete log relations). Crucially this also makes
    the RESULT safe when individual terms cancel (e.g. the delta commitment
    of a balanced input/output pair, where [q]K_in - [q]K_out = O): the
    cancellation happens inside the blinded accumulator, never as a raw
    P + (-P) incomplete add. Mirrors integrity.rs:546-630's use of halo2's
    complete formulas, with rows ~ max_len*(1 dbl + #active cond-adds)."""
    max_len = max(len(bits) for _, bits in terms)
    acc = constant_point(b, blind)
    for i in range(max_len - 1, -1, -1):
        acc = ec_dbl_gadget(b, acc)
        for point, bits in terms:
            if i < len(bits):
                acc = ec_cond_add_gadget(b, acc, point, bits[i])
    corr = -(blind * (1 << max_len))
    return ec_add_gadget(b, acc, constant_point(b, corr))


def ec_neg_point(b: CircuitBuilder, p: PointCells) -> PointCells:
    """(x, -y) — one vanilla row."""
    zero = G.constant_cell(b, 0)
    return PointCells(p.x, G.sub_cells(b, zero, p.y))


def ec_scalar_mul_gadget(
    b: CircuitBuilder, point: PointCells, scalar_bits, blind: PallasPoint
) -> PointCells:
    """[s]P for s given as little-endian boolean cells (2 rows per bit).
    Accumulator starts at the blinding base T and ends subtracting [2^len]T,
    so every intermediate add is between (w.h.p.) unrelated points —
    incomplete adds are safe."""
    t = blind
    acc = constant_point(b, t)
    # MSB-first double-and-add: acc = 2*acc + bit*P (fused cond-add row)
    for bit in reversed(scalar_bits):
        acc = ec_dbl_gadget(b, acc)
        acc = ec_cond_add_gadget(b, acc, point, bit)
    # subtract [2^len] T: acc + (-[2^len] T)
    corr = -(t * (1 << len(scalar_bits)))
    return ec_add_gadget(b, acc, constant_point(b, corr))


def blind_base(tag: bytes = b"acc") -> PallasPoint:
    """Deterministic accumulator-blinding point (no known discrete log)."""
    from ..crypto.curves import pallas_hash_to_curve

    return pallas_hash_to_curve("taiga-tpu-ec-blind", tag)


def decompose_canonical_255(b: CircuitBuilder, cell, one_cell=None,
                            _witness_value=None):
    """Canonical (< p) 255-bit little-endian BIT decomposition of a field
    cell — the sound counterpart of halo2's ScalarVar::from_base, for scalar
    multiplications that consume individual bits.

    Canonicity mirrors blake2s.field_to_words: p = 2^254 + T_LOW with
    T_LOW < 2^126, so the decomposition is canonical iff bit255 = 0 and, when
    bit254 = 1, bits 126..253 are all zero and the low 126 bits are
    <= T_LOW - 1 (borrow witness, lookup-range-checked).

    _witness_value: TEST-ONLY override of the decomposed integer (e.g. v+p),
    used to regression-check that non-canonical witnesses are rejected."""
    from . import spread as S
    from .blake2s import MASK32, T_LOW

    v = cell.value if _witness_value is None else _witness_value
    words = []
    for j in range(8):
        wv = None if v is None else (v >> (32 * j)) & MASK32
        words.append(G.word_bits_region(b, wv))
    acc = words[0][1]
    for j in range(1, 8):
        acc = G.add_scaled(b, acc, words[j][1], 1 << (32 * j))
    G.assert_equal(b, acc, cell)

    b254, b255 = words[7][0][30], words[7][0][31]
    G.assert_equal_constant(b, b255, 0)
    hi = b254
    for j in (4, 5, 6):
        z = G.mul_cells(b, hi, words[j][1])
        G.assert_equal_constant(b, z, 0)
    # w7 low 30 bits zero when hi (b255 = 0): low30 = w7 - hi*2^30
    low30 = G.add_scaled(b, words[7][1], hi, P - (1 << 30))
    z = G.mul_cells(b, hi, low30)
    G.assert_equal_constant(b, z, 0)
    # w3 top two bits (126,127) zero when hi
    t2 = G.add_scaled(b, words[3][0][30], words[3][0][31], 2)
    z = G.mul_cells(b, hi, t2)
    G.assert_equal_constant(b, z, 0)
    # borrow: d = hi * (T_LOW - 1 - lo126) must be a 126-bit value
    lo = words[0][1]
    for j in (1, 2, 3):
        lo = G.add_scaled(b, lo, words[j][1], 1 << (32 * j))
    tv = None if lo.value is None else (T_LOW - 1 - lo.value) % P
    ca, _, tcell = G.assign_vanilla(b, ql=P - 1, qc=(T_LOW - 1) % P, qo=P - 1,
                                    va=lo.value, vc=tv)
    b.copy(ca, lo)
    d = G.mul_cells(b, hi, tcell)
    S.lookup_range_check(b, d, 126)

    bits = [bit for w, _ in words for bit in w]
    return bits[:255]  # bit 255 is constrained to zero
