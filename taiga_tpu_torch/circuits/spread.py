"""Spread-table lookup gadgets: byte range checks, 32-bit XOR-rotate, add mod
2^32 — the machinery that makes the in-circuit Blake2s small.

The reference pays for XOR with spread plonk gates and a lookup table
(taiga_halo2/src/circuit/blake2s.rs:882-935 XOR via spread; compliance config
carries a 2^10 lookup table, compliance_circuit.rs:38-50). We use one 2^8
dense->spread table with five lookup arguments (one per chunk slot):

  spread(x) interleaves zero bits: bit i of x -> bit 2i. XOR falls out of
  field addition of spreads: spread(x) + spread(y) = spread(x^y) + 2*spread(x&y),
  so witnessing even/odd chunk pairs (ze, zo) of the spread sum and range-
  checking them via the table yields z = x^y (dense AND spread form, free).

  Rotations come for free by decomposing into chunks aligned to the rotation
  boundary (Blake2s uses rotr 16/12/8/7) and recombining with rotated weights
  — chunk widths (8,8,8,8) for 16/8/0 and (4,8,8,8,4) / (7,8,8,8,1) for 12/7.
  Sub-byte chunks reuse the byte table with a scaled lookup: (2^s*x, 4^s*x_sp)
  is in the table iff x < 2^(8-s) and x_sp = spread(x).

Column usage (on top of gadgets.py's standard config):
  advice: a0..a9 = five (dense, spread) chunk-cell pairs; a10, a11 = gadget-
  specific (operands / outputs).
  fixed: TD, TS = the dense/spread table columns; QS0..QS4 = per-slot chunk
  scale (0 = slot inactive; 2^s = chunk of width 8-s); per-gadget selectors.

A 32-bit word is a SpreadWord: a dense field cell plus a spread field cell
(spread(w) < 2^64 fits Fp). Both forms stay materialized through the hash so
consumers never re-decompose.
"""

from __future__ import annotations

from ..crypto.fields import Fp
from ..plonk.circuit import CircuitBuilder, ConstraintSystem
from ..plonk.expression import Constant
from . import gadgets as G

P = Fp.MODULUS
MASK32 = 0xFFFFFFFF


def spread(x: int) -> int:
    """Interleave zeros: bit i -> bit 2i (x < 2^32 -> result < 2^64)."""
    s = 0
    i = 0
    while x:
        s |= (x & 1) << (2 * i)
        x >>= 1
        i += 1
    return s


_SPREAD_BYTE = [spread(i) for i in range(256)]


def unspread_even(s: int) -> int:
    """Even bits of s, compacted (the XOR of the two spread summands)."""
    x = 0
    i = 0
    while s:
        x |= (s & 1) << i
        s >>= 2
        i += 1
    return x


# chunk widths per rotation: cover [0,32) with boundaries aligned so rotr(n)
# is a cyclic chunk shift. offsets[i] = start bit of chunk i.
ROT_CHUNKS = {
    0: (8, 8, 8, 8),
    8: (8, 8, 8, 8),
    16: (8, 8, 8, 8),
    12: (4, 8, 8, 8, 4),
    7: (7, 8, 8, 8, 1),
}


def _offsets(widths):
    offs = []
    o = 0
    for w in widths:
        offs.append(o)
        o += w
    assert o == 32
    return offs


class SpreadConfig:
    """Fixed/advice column indices for the spread gadgets (extends the
    standard gadget config; see configure_spread)."""

    def __init__(self, base_fixed: int):
        self.TD = base_fixed + 0  # table: dense byte
        self.TS = base_fixed + 1  # table: spread(byte)
        self.QS = [base_fixed + 2 + j for j in range(5)]  # per-slot scales
        self.Q_ADD32 = base_fixed + 7
        self.Q_XR = {
            rot: base_fixed + 8 + i for i, rot in enumerate((0, 8, 16, 12, 7))
        }
        self.num_fixed_end = base_fixed + 13

    # advice slots: pair j = (a_{2j}, a_{2j+1}), j in 0..4
    DENSE = [0, 2, 4, 6, 8]
    SPREADC = [1, 3, 5, 7, 9]
    X10, X11 = 10, 11


# the standard config's spread extension (gadgets.py NUM_FIXED base = 16)
SC = SpreadConfig(16)


def configure_spread(cs: ConstraintSystem, sc: SpreadConfig):
    """Register the lookup arguments and the add32 / xor-rotate gates."""
    a = [cs.advice(i) for i in range(12)]
    td = cs.fixed(sc.TD)
    ts = cs.fixed(sc.TS)

    # five chunk-slot lookup arguments; qs doubles as selector (0 = off, row
    # contributes (0,0) which is table row 0) and chunk scale 2^s
    for j in range(5):
        qs = cs.fixed(sc.QS[j])
        cs.lookup(
            f"spread_{j}",
            [(qs * a[2 * j], td), (qs * qs * a[2 * j + 1], ts)],
        )

    # --- add32: row r = 4 byte pairs + carry(a10) + ops(a9? no: ops on a8..)
    # layout row r:   a0..a7 = byte pairs of the result, a8 = carry,
    #                 a9,a10,a11 = op1, op2, op3 (copies; zero cell if unused)
    #         row r+1: a10 = z_dense, a11 = z_spread
    q = cs.fixed(sc.Q_ADD32)
    dense_sum = None
    spread_sum = None
    for j in range(4):
        dt = Constant(1 << (8 * j)) * a[2 * j]
        st_ = Constant(1 << (16 * j)) * a[2 * j + 1]
        dense_sum = dt if dense_sum is None else dense_sum + dt
        spread_sum = st_ if spread_sum is None else spread_sum + st_
    carry = a[8]
    # NOTE: a8 slot overlaps pair-4's dense column; q_add32 rows must keep
    # QS[4] = 0 so the 5th lookup slot is inactive there.
    cs.create_gate(
        "add32_sum",
        q * (a[9] + a[10] + a[11] - dense_sum - Constant(1 << 32) * carry),
    )
    cs.create_gate("add32_dense", q * (a[10].at(1) - dense_sum))
    cs.create_gate("add32_spread", q * (a[11].at(1) - spread_sum))
    cs.create_gate(
        "add32_carry",
        q * carry * (carry - Constant(1)) * (carry - Constant(2)),
    )

    # --- xor_rot gates, one per rotation amount ------------------------
    # layout row r:   a0..a9 = even chunk pairs (ze_j, ze_sp_j)
    #                 a10 = x_spread (copy), a11 = y_spread (copy)
    #         row r+1: a0..a9 = odd chunk pairs (zo_j, zo_sp_j)
    #                 a10 = z_dense, a11 = z_spread
    for rot, qidx in sc.Q_XR.items():
        widths = ROT_CHUNKS[rot]
        offs = _offsets(widths)
        qx = cs.fixed(qidx)
        sum_expr = None  # sum over chunks of 4^off * (ze_sp + 2 zo_sp)
        zd_expr = None  # rotated dense recomposition
        zs_expr = None  # rotated spread recomposition
        for j, (w, off) in enumerate(zip(widths, offs)):
            ze = a[2 * j]
            ze_sp = a[2 * j + 1]
            zo_sp = a[2 * j + 1].at(1)
            term = Constant(pow(4, off, P)) * (ze_sp + Constant(2) * zo_sp)
            sum_expr = term if sum_expr is None else sum_expr + term
            roff = (off - rot) % 32
            zd_t = Constant(1 << roff) * ze
            zs_t = Constant(pow(4, roff, P)) * ze_sp
            zd_expr = zd_t if zd_expr is None else zd_expr + zd_t
            zs_expr = zs_t if zs_expr is None else zs_expr + zs_t
        cs.create_gate(f"xr{rot}_sum", qx * (a[10] + a[11] - sum_expr))
        cs.create_gate(f"xr{rot}_dense", qx * (a[10].at(1) - zd_expr))
        cs.create_gate(f"xr{rot}_spread", qx * (a[11].at(1) - zs_expr))


def ensure_table(b: CircuitBuilder, sc: SpreadConfig):
    """Lazily reserve+fill the 256-row table on first gadget use (synthesis
    order is deterministic, so keygen and prove agree on its placement)."""
    if not hasattr(b, "_spread_table"):
        b._spread_table = fill_table(b, sc)


def fill_table(b: CircuitBuilder, sc: SpreadConfig, rows: int = 0):
    """Assign the 256-entry dense/spread table at the given base row (tables
    live at fixed rows 0..255; callers must reserve them before any gadget)."""
    base = b.alloc_rows(256)
    for i in range(256):
        b.assign_fixed(sc.TD, base + i, i)
        b.assign_fixed(sc.TS, base + i, _SPREAD_BYTE[i])
    return base


class SpreadWord:
    """A 32-bit word as (dense cell, spread cell), or a constant."""

    __slots__ = ("const", "dense", "sp")

    def __init__(self, const=None, dense=None, sp=None):
        self.const = const
        self.dense = dense
        self.sp = sp

    @property
    def value(self):
        if self.const is not None:
            return self.const
        return self.dense.value

    def dense_cell(self, b: CircuitBuilder, cache: dict):
        if self.const is not None:
            return _const_cell(b, cache, self.const)
        return self.dense

    def spread_cell(self, b: CircuitBuilder, cache: dict):
        if self.const is not None:
            return _const_cell(b, cache, spread(self.const))
        return self.sp


def _const_cell(b: CircuitBuilder, cache: dict, v: int):
    if v not in cache:
        cache[v] = G.constant_cell(b, v)
    return cache[v]


def _chunks_of(v, widths):
    """Split a 32-bit value into LSB-first chunks of the given widths."""
    out = []
    for w in widths:
        out.append(v & ((1 << w) - 1))
        v >>= w
    return out


def _cache(b: CircuitBuilder) -> dict:
    if not hasattr(b, "_sp_consts"):
        b._sp_consts = {}
    return b._sp_consts


def witness_spread_word(b: CircuitBuilder, value, sc: SpreadConfig = SC):
    """Witness a fresh 32-bit word with its spread form bound (2 rows).
    Reuses the Q_ADD32 gate with op1 = the word itself and op2 = op3 = 0, so
    the byte pairs are lookup-checked and both output cells are constrained.
    value may be None (keygen)."""
    ensure_table(b, sc)
    cache = _cache(b)
    zero = _const_cell(b, cache, 0)
    row = b.alloc_rows(2)
    b.assign_fixed(sc.Q_ADD32, row, 1)
    zd = None if value is None else value & MASK32
    zs = None if zd is None else spread(zd)
    bytes_ = _chunks_of(zd, (8, 8, 8, 8)) if zd is not None else [None] * 4
    for j in range(4):
        b.assign_fixed(sc.QS[j], row, 1)
        dv = bytes_[j]
        sv = None if dv is None else _SPREAD_BYTE[dv]
        b.assign_advice(2 * j, row, dv)
        b.assign_advice(2 * j + 1, row, sv)
    b.assign_advice(8, row, 0 if value is not None else None)  # carry
    zd_cell = b.assign_advice(10, row + 1, zd)
    zs_cell = b.assign_advice(11, row + 1, zs)
    op1 = b.assign_advice(9, row, zd)
    b.copy(op1, zd_cell)
    for col in (10, 11):
        c = b.assign_advice(col, row, 0 if value is not None else None)
        b.copy(c, zero)
    return SpreadWord(dense=zd_cell, sp=zs_cell)


def add32(b: CircuitBuilder, words, sc: SpreadConfig = SC) -> SpreadWord:
    """Sum of 2 or 3 SpreadWords mod 2^32 (2 rows). Returns SpreadWord with
    both dense and spread cells bound."""
    ensure_table(b, sc)
    cache = _cache(b)
    assert 2 <= len(words) <= 3
    ops = list(words) + [SpreadWord(const=0)] * (3 - len(words))
    vals = [w.value for w in ops]
    known = all(v is not None for v in vals)
    total = sum(vals) if known else None
    zd = None if total is None else total & MASK32
    carry = None if total is None else total >> 32
    zs = None if zd is None else spread(zd)

    row = b.alloc_rows(2)
    b.assign_fixed(sc.Q_ADD32, row, 1)
    bytes_ = _chunks_of(zd, (8, 8, 8, 8)) if zd is not None else [None] * 4
    for j in range(4):
        b.assign_fixed(sc.QS[j], row, 1)
        dv = bytes_[j]
        sv = None if dv is None else _SPREAD_BYTE[dv]
        b.assign_advice(2 * j, row, dv)
        b.assign_advice(2 * j + 1, row, sv)
    b.assign_advice(8, row, carry)
    for col, w in zip((9, 10, 11), ops):
        c = b.assign_advice(col, row, w.value)
        b.copy(c, w.dense_cell(b, cache))
    zd_cell = b.assign_advice(10, row + 1, zd)
    zs_cell = b.assign_advice(11, row + 1, zs)
    return SpreadWord(dense=zd_cell, sp=zs_cell)


def xor_rot(b: CircuitBuilder, x: SpreadWord, y: SpreadWord,
            rot: int = 0, sc: SpreadConfig = SC) -> SpreadWord:
    """z = rotr(x ^ y, rot) in 2 rows. rot must be one of ROT_CHUNKS."""
    cache = _cache(b)
    if not (x.const is not None and y.const is not None):
        ensure_table(b, sc)
    if x.const is not None and y.const is not None:
        return SpreadWord(const=((x.const ^ y.const) >> rot
                                 | (x.const ^ y.const) << (32 - rot)) & MASK32)
    widths = ROT_CHUNKS[rot]
    offs = _offsets(widths)
    xs = x.spread_cell(b, cache)
    ys = y.spread_cell(b, cache)
    known = xs.value is not None and ys.value is not None
    if known:
        s = xs.value + ys.value
        ze = unspread_even(s)  # == x ^ y
        zo = unspread_even(s >> 1)  # == x & y
        ze_chunks = _chunks_of(ze, widths)
        zo_chunks = _chunks_of(zo, widths)
        zrot = ((ze >> rot) | (ze << (32 - rot))) & MASK32
    else:
        ze_chunks = zo_chunks = [None] * len(widths)
        zrot = None

    row = b.alloc_rows(2)
    b.assign_fixed(sc.Q_XR[rot], row, 1)
    for j, w in enumerate(widths):
        scale = 1 << (8 - w)
        b.assign_fixed(sc.QS[j], row, scale)
        b.assign_fixed(sc.QS[j], row + 1, scale)
        for r_, chunks in ((row, ze_chunks), (row + 1, zo_chunks)):
            cv = chunks[j]
            sv = None if cv is None else spread(cv)
            b.assign_advice(2 * j, r_, cv)
            b.assign_advice(2 * j + 1, r_, sv)
    cx = b.assign_advice(10, row, xs.value)
    cy = b.assign_advice(11, row, ys.value)
    b.copy(cx, xs)
    b.copy(cy, ys)
    zs_val = None if zrot is None else spread(zrot)
    zd_cell = b.assign_advice(10, row + 1, zrot)
    zs_cell = b.assign_advice(11, row + 1, zs_val)
    return SpreadWord(dense=zd_cell, sp=zs_cell)


def lookup_range_check(b: CircuitBuilder, cell, num_bits: int,
                       sc: SpreadConfig = SC):
    """cell < 2^num_bits via byte-table lookups: ceil(num_bits/8) chunk pairs
    packed 4 per row, recomposed with a vanilla chain (replaces the 1-row-per-
    bit decompose_bits for pure range checks; reference uses halo2's
    LookupRangeCheckConfig, compliance_circuit.rs:38-50)."""
    ensure_table(b, sc)
    v = cell.value
    nchunks = -(-num_bits // 8)
    last_w = num_bits - 8 * (nchunks - 1)
    dcells = []
    for base in range(0, nchunks, 4):
        row = b.alloc_rows(1)
        for j in range(min(4, nchunks - base)):
            ci = base + j
            w = 8 if ci < nchunks - 1 else last_w
            b.assign_fixed(sc.QS[j], row, 1 << (8 - w))
            cv = None if v is None else (v >> (8 * ci)) & ((1 << w) - 1)
            sv = None if cv is None else spread(cv)
            dcells.append(b.assign_advice(2 * j, row, cv))
            b.assign_advice(2 * j + 1, row, sv)
    acc = None
    for i, dc in enumerate(dcells):
        if acc is None:
            acc = G.mul_const(b, dc, 1)
        else:
            acc = G.add_scaled(b, acc, dc, 1 << (8 * i))
    G.assert_equal(b, acc, cell)
