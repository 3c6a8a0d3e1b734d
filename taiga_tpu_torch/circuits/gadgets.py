"""Standard circuit configuration and gadget library.

Column layout (shared by the compliance and resource-logic circuits):
  advice a0..a11 (12 columns)
    - a0..a2: arithmetic / poseidon state lanes
    - a3..a10: bit lanes (8 bits per row) for decomposition/xor gadgets
    - a11: word lane for recompositions
  fixed:
    f0..f4:  vanilla-gate coefficients q_l q_r q_m q_o q_c (on a0,a1,a2)
    f5..f7:  poseidon round constants rc0 rc1 rc2
    f8:      q_pos_full   (poseidon full-round gate, state -> next row)
    f9:      q_pos_part   (poseidon partial-round gate)
    f10:     q_bits       (a3..a10 boolean on this row)
    f11:     q_xor        (a3..a10 rows r,r+1 -> r+2 bitwise xor)
    f12:     q_recomp     (a11 = sum of 32 bits at rows r..r+3 over a3..a10)
    f13:     q_ec_add     (incomplete affine add on one row)
    f14:     q_ec_dbl     (affine double on one row)
    f15:     q_ec_sel_add (conditional: bit ? acc+P : acc, one row)

Gates keep degree <= 6 (MAX_GATE_DEGREE 7). Gadget functions assign witness
values (host ints) and the matching fixed cells; rows allocate sequentially.

Statement parity references: integrity gadgets mirror
taiga_halo2/src/circuit/integrity.rs; merkle gadget mirrors
circuit/merkle_circuit.rs; poseidon gate mirrors halo2_gadgets Pow5Chip
semantics (via crypto/poseidon.py).
"""

from __future__ import annotations

from ..crypto import poseidon as hp
from ..crypto.fields import Fp
from ..plonk.circuit import CircuitBuilder, ConstraintSystem
from ..plonk.expression import Constant

P = Fp.MODULUS

NUM_ADVICE = 12
# 16 standard + 13 spread-lookup columns (spread.py SC) + 9 extra poseidon
# round-constant columns (4 rounds per row x 3 lanes) + cond-swap selector
NUM_FIXED = 39

# fixed column indices
QL, QR, QM, QO, QC = 0, 1, 2, 3, 4
RC0, RC1, RC2 = 5, 6, 7
Q_POS_4F, Q_POS_4P = 8, 9  # poseidon 4-full / 4-partial rounds per row
Q_BITS, Q_XOR, Q_RECOMP = 10, 11, 12
Q_EC_ADD, Q_EC_DBL, Q_EC_SEL_ADD = 13, 14, 15
RC_EXT = list(range(29, 38))  # RC3..RC11 (transitions 1..3 of a packed row)
Q_SWAP = 38  # conditional swap (merkle levels), one row

BIT_COLS = list(range(3, 11))  # a3..a10
WORD_COL = 11


def configure_standard(cs: ConstraintSystem):
    """Install all standard gates; returns nothing (config is implicit)."""
    a = [cs.advice(i) for i in range(NUM_ADVICE)]
    f = [cs.fixed(i) for i in range(NUM_FIXED)]

    # vanilla: q_l*a0 + q_r*a1 + q_m*a0*a1 + q_o*a2 + q_c = 0
    cs.create_gate(
        "vanilla",
        f[QL] * a[0] + f[QR] * a[1] + f[QM] * a[0] * a[1] + f[QO] * a[2] + f[QC],
    )

    # poseidon, 4 rounds per row: states S0..S3 live in (a0..a2), (a3..a5),
    # (a6..a8), (a9..a11) of row r; S4 is (a0..a2) of row r+1. Transition t
    # uses round constants at columns (RC0..RC2) for t=0 and RC_EXT for
    # t=1..3. Gate degree: selector * MDS(sbox) = 6.
    mds = hp.MDS

    def sbox(x):
        x2 = x * x
        return x2 * x2 * x

    rc_cols = [RC0, RC1, RC2] + RC_EXT  # 12 = 4 transitions x 3 lanes

    def state(t):
        if t < 4:
            return [a[3 * t + i] for i in range(3)]
        return [a[i].at(1) for i in range(3)]

    for t in range(4):
        s_in = state(t)
        s_out = state(t + 1)
        rcs = [f[rc_cols[3 * t + i]] for i in range(3)]
        full_in = [sbox(s_in[i] + rcs[i]) for i in range(3)]
        part_in = [sbox(s_in[0] + rcs[0]), s_in[1] + rcs[1], s_in[2] + rcs[2]]
        for i in range(3):
            full_out = (
                Constant(mds[i][0]) * full_in[0]
                + Constant(mds[i][1]) * full_in[1]
                + Constant(mds[i][2]) * full_in[2]
            )
            part_out = (
                Constant(mds[i][0]) * part_in[0]
                + Constant(mds[i][1]) * part_in[1]
                + Constant(mds[i][2]) * part_in[2]
            )
            cs.create_gate(f"pos4f_{t}_{i}", f[Q_POS_4F] * (full_out - s_out[i]))
            cs.create_gate(f"pos4p_{t}_{i}", f[Q_POS_4P] * (part_out - s_out[i]))

    # bits: a3..a10 boolean
    for i, c in enumerate(BIT_COLS):
        cs.create_gate(f"bit_{i}", f[Q_BITS] * a[c] * (a[c] - Constant(1)))

    # xor: row r ^ row r+1 == row r+2 per bit column
    for i, c in enumerate(BIT_COLS):
        x, y, z = a[c], a[c].at(1), a[c].at(2)
        cs.create_gate(f"xor_{i}", f[Q_XOR] * (x + y - Constant(2) * x * y - z))

    # recomposition: a11[r] = sum_{j<4} sum_{i<8} bit[r+j][i] * 2^(8j+i)
    acc = None
    for j in range(4):
        for i, c in enumerate(BIT_COLS):
            term = Constant(1 << (8 * j + i)) * a[c].at(j)
            acc = term if acc is None else acc + term
    cs.create_gate("recomp32", f[Q_RECOMP] * (acc - a[WORD_COL]))

    # EC gates (Pallas, a=0 b=5), one row each:
    # add: cells x1,y1,x2,y2,lambda,x3,y3 in a0..a6 (incomplete: x1 != x2)
    x1, y1, x2, y2, lam, x3, y3 = (a[i] for i in range(7))
    cs.create_gate("ec_add_1", f[Q_EC_ADD] * ((x2 - x1) * lam - (y2 - y1)))
    cs.create_gate("ec_add_2", f[Q_EC_ADD] * (lam * lam - x1 - x2 - x3))
    cs.create_gate("ec_add_3", f[Q_EC_ADD] * (lam * (x1 - x3) - y1 - y3))
    # dbl: cells x1,y1,lambda,x3,y3 in a0..a4
    dx1, dy1, dlam, dx3, dy3 = (a[i] for i in range(5))
    cs.create_gate("ec_dbl_1", f[Q_EC_DBL] * (Constant(2) * dy1 * dlam - Constant(3) * dx1 * dx1))
    cs.create_gate("ec_dbl_2", f[Q_EC_DBL] * (dlam * dlam - Constant(2) * dx1 - dx3))
    cs.create_gate("ec_dbl_3", f[Q_EC_DBL] * (dlam * (dx1 - dx3) - dy1 - dy3))
    # conditional add (one row): cells x1,y1,x2,y2,lam,x3,y3,bit in a0..a7.
    # bit=1 -> (x3,y3) = (x1,y1) + (x2,y2) (incomplete); bit=0 -> passthrough.
    # bit must be boolean-constrained by the caller (q_bits rows).
    sx1, sy1, sx2, sy2, slam, sx3, sy3, sbit = (a[i] for i in range(8))
    one = Constant(1)
    cs.create_gate(
        "ec_sel_add_1", f[Q_EC_SEL_ADD] * sbit * ((sx2 - sx1) * slam - (sy2 - sy1))
    )
    cs.create_gate(
        "ec_sel_add_2",
        f[Q_EC_SEL_ADD]
        * (sbit * (slam * slam - sx1 - sx2 - sx3) + (one - sbit) * (sx3 - sx1)),
    )
    cs.create_gate(
        "ec_sel_add_3",
        f[Q_EC_SEL_ADD]
        * (sbit * (slam * (sx1 - sx3) - sy1 - sy3) + (one - sbit) * (sy3 - sy1)),
    )

    # conditional swap (one row): cells l, r, bit, out_l, out_r in a0..a4;
    # bit=1 -> (out_l,out_r) = (r,l), bit=0 -> (l,r). bit must be boolean-
    # constrained by the caller. (halo2_gadgets CondSwapChip counterpart.)
    wl, wr, wbit, wol, wor = (a[i] for i in range(5))
    cs.create_gate("swap_l", f[Q_SWAP] * (wol - wl - wbit * (wr - wl)))
    cs.create_gate("swap_r", f[Q_SWAP] * (wor - wr - wbit * (wl - wr)))

    # spread-lookup extension: byte table, chunk lookups, add32/xor-rot gates
    from .spread import SC, configure_spread

    assert SC.num_fixed_end == RC_EXT[0] <= NUM_FIXED
    configure_spread(cs, SC)


# ---------------------------------------------------------------------------
# gadget assignment helpers
# ---------------------------------------------------------------------------


def assign_vanilla(b: CircuitBuilder, ql=0, qr=0, qm=0, qo=0, qc=0, va=None, vb=None, vc=None):
    """One vanilla-gate row; returns the three advice cells."""
    row = b.alloc_rows(1)
    for col, v in ((QL, ql), (QR, qr), (QM, qm), (QO, qo), (QC, qc)):
        if v:
            b.assign_fixed(col, row, v)
    ca = b.assign_advice(0, row, va)
    cb = b.assign_advice(1, row, vb)
    cc = b.assign_advice(2, row, vc)
    return ca, cb, cc


def constant_cell(b: CircuitBuilder, value: int):
    """A cell constrained to a compile-time constant: a0 + (-value) = 0.
    Cached per builder — repeated constants cost one row total."""
    value = value % P
    cache = getattr(b, "_const_cells", None)
    if cache is None:
        cache = b._const_cells = {}
    cell = cache.get(value)
    if cell is None:
        ca, _, _ = assign_vanilla(b, ql=1, qc=(-value) % P, va=value)
        cell = cache[value] = ca
    return cell


def add_cells(b: CircuitBuilder, x, y):
    """c = x + y."""
    val = None if x.value is None or y.value is None else (x.value + y.value) % P
    ca, cb, cc = assign_vanilla(b, ql=1, qr=1, qo=P - 1, va=x.value, vb=y.value, vc=val)
    b.copy(ca, x)
    b.copy(cb, y)
    return cc


def sub_cells(b: CircuitBuilder, x, y):
    val = None if x.value is None or y.value is None else (x.value - y.value) % P
    ca, cb, cc = assign_vanilla(b, ql=1, qr=P - 1, qo=P - 1, va=x.value, vb=y.value, vc=val)
    b.copy(ca, x)
    b.copy(cb, y)
    return cc


def mul_cells(b: CircuitBuilder, x, y):
    val = None if x.value is None or y.value is None else x.value * y.value % P
    ca, cb, cc = assign_vanilla(b, qm=1, qo=P - 1, va=x.value, vb=y.value, vc=val)
    b.copy(ca, x)
    b.copy(cb, y)
    return cc


def assert_equal(b: CircuitBuilder, x, y):
    b.copy(x, y)


def assert_equal_constant(b: CircuitBuilder, x, value: int):
    """x == constant via q_l*x + q_c = 0."""
    ca, _, _ = assign_vanilla(b, ql=1, qc=(-value) % P, va=x.value)
    b.copy(ca, x)


def witness_cell(b: CircuitBuilder, value):
    """A free advice cell (no gate), e.g. for public-input exposure."""
    row = b.alloc_rows(1)
    return b.assign_advice(0, row, value)


def select_cell(b: CircuitBuilder, flag, x, y):
    """flag ? x : y  ==  y + flag*(x - y); flag must be boolean elsewhere."""
    d = sub_cells(b, x, y)
    fd = mul_cells(b, flag, d)
    return add_cells(b, fd, y)


def is_bool(b: CircuitBuilder, x):
    """x*(x-1) = 0 via vanilla gate: q_m*x*x + q_l*(-1)*x = 0."""
    ca, cb, _ = assign_vanilla(b, qm=1, ql=P - 1, va=x.value, vb=x.value)
    b.copy(ca, x)
    b.copy(cb, x)


# --- poseidon --------------------------------------------------------------


def poseidon_permute(b: CircuitBuilder, state):
    """In-circuit Poseidon permutation; state = 3 cells -> 3 cells (17 rows:
    16 packed rows of 4 rounds each + the final-state row). The P128Pow5T3
    schedule (4 full | 56 partial | 4 full) aligns exactly with 4-round rows:
    row 0 is full, rows 1..14 partial, row 15 full."""
    vals = [c.value for c in state]
    known = all(v is not None for v in vals)
    half = hp.FULL_ROUNDS // 2
    assert half == 4 and hp.PARTIAL_ROUNDS % 4 == 0
    nrows = (hp.FULL_ROUNDS + hp.PARTIAL_ROUNDS) // 4
    rows = b.alloc_rows(nrows + 1)
    rc_cols = [RC0, RC1, RC2] + RC_EXT
    # seed: copy the input state into (a0,a1,a2) of the first row
    cur = []
    for i in range(3):
        cell = b.assign_advice(i, rows, vals[i])
        b.copy(cell, state[i])
        cur.append(cell)
    cur_vals = list(vals)
    for blk in range(nrows):
        row = rows + blk
        r0 = 4 * blk
        is_full = r0 < half or r0 >= half + hp.PARTIAL_ROUNDS
        b.assign_fixed(Q_POS_4F if is_full else Q_POS_4P, row, 1)
        for t in range(4):
            rc = hp.ROUND_CONSTANTS[r0 + t]
            for i in range(3):
                b.assign_fixed(rc_cols[3 * t + i], row, rc[i])
            if known:
                s = [(cur_vals[i] + rc[i]) % P for i in range(3)]
                if is_full:
                    s = [pow(x, 5, P) for x in s]
                else:
                    s[0] = pow(s[0], 5, P)
                cur_vals = [
                    sum(hp.MDS[i][j] * s[j] for j in range(3)) % P
                    for i in range(3)
                ]
            else:
                cur_vals = [None, None, None]
            # intermediate states within the row; the 4th lands on row+1
            dst_row, dst_cols = (
                (row, (3 * (t + 1), 3 * (t + 1) + 1, 3 * (t + 1) + 2))
                if t < 3
                else (row + 1, (0, 1, 2))
            )
            cur = [
                b.assign_advice(dst_cols[i], dst_row, cur_vals[i])
                for i in range(3)
            ]
    return cur


def poseidon_hash_n_gadget(b: CircuitBuilder, message):
    """ConstantLength<L> hash over cells; mirrors crypto.poseidon._hash_ints."""
    L_ = len(message)
    cap = constant_cell(b, (L_ << 64) % P)
    zero = constant_cell(b, 0)
    state = [zero, zero, cap]
    k = -(-L_ // 2)
    padded = list(message) + [zero] * (k * 2 - L_)
    for c in range(k):
        s0 = add_cells(b, state[0], padded[2 * c])
        s1 = add_cells(b, state[1], padded[2 * c + 1])
        state = poseidon_permute(b, [s0, s1, state[2]])
    return state[0]


def poseidon_hash2_gadget(b: CircuitBuilder, left, right):
    return poseidon_hash_n_gadget(b, [left, right])


# --- merkle ----------------------------------------------------------------


def cond_swap_gadget(b: CircuitBuilder, l, r, bit):
    """(bit ? (r,l) : (l,r)) in one Q_SWAP row; bit boolean elsewhere."""
    row = b.alloc_rows(1)
    b.assign_fixed(Q_SWAP, row, 1)
    known = l.value is not None and r.value is not None and bit.value is not None
    if known:
        ov = (r.value, l.value) if bit.value else (l.value, r.value)
    else:
        ov = (None, None)
    cl = b.assign_advice(0, row, l.value)
    cr = b.assign_advice(1, row, r.value)
    cb = b.assign_advice(2, row, bit.value)
    col = b.assign_advice(3, row, ov[0])
    cor = b.assign_advice(4, row, ov[1])
    b.copy(cl, l)
    b.copy(cr, r)
    b.copy(cb, bit)
    return col, cor


def merkle_root_gadget(b: CircuitBuilder, leaf, path):
    """Fold a Poseidon Merkle path; path = [(sibling_cell, lr_is_left_bit_cell)].

    lr bit semantics: 1 => sibling is the LEFT child (reference merkle_tree.rs
    LR::L), 0 => sibling is the right child. Bits must be boolean-constrained
    by the caller (or come from constants).
    """
    node = leaf
    for sibling, lr_bit in path:
        left, right = cond_swap_gadget(b, node, sibling, lr_bit)
        node = poseidon_hash2_gadget(b, left, right)
    return node


# --- bit decomposition ------------------------------------------------------


def decompose_bits(b: CircuitBuilder, cell, num_bits: int):
    """Decompose a cell into `num_bits` boolean cells (LSB first) + enforce
    recomposition. Built from 32-bit q_recomp word regions (4 rows + 1 word
    cell each) joined by a short vanilla chain — ~5 rows per 32 bits instead
    of the old 1-row-per-bit recomposition chain. Bits beyond num_bits are
    constrained to zero. NOTE: for num_bits >= 255 the decomposition is NOT
    automatically canonical; use ec_gadgets.decompose_canonical_255 when
    uniqueness matters (e.g. scalars feeding commitments)."""
    v = cell.value
    bits = []
    nwords = -(-num_bits // 32)
    word_cells = []
    for j in range(nwords):
        wv = None if v is None else (v >> (32 * j)) & 0xFFFFFFFF
        wbits, wcell = word_bits_region(b, wv)
        word_cells.append(wcell)
        bits.extend(wbits)
    for idx in range(num_bits, 32 * nwords):
        assert_equal_constant(b, bits[idx], 0)
    acc = word_cells[0]
    for j in range(1, nwords):
        acc = add_scaled(b, acc, word_cells[j], 1 << (32 * j))
    assert_equal(b, acc, cell)
    return bits[:num_bits]


def word_bits_region(b: CircuitBuilder, value):
    """A 32-bit word as 32 boolean bit cells (LSB first; 4 rows x 8 bit
    lanes) plus a q_recomp-bound word cell on the first row. value: int |
    None. Returns (bits, word_cell)."""
    rows = b.alloc_rows(4)
    bits = []
    for j in range(4):
        b.assign_fixed(Q_BITS, rows + j, 1)
        for i in range(8):
            idx = 8 * j + i
            bv = None if value is None else (value >> idx) & 1
            bits.append(b.assign_advice(BIT_COLS[i], rows + j, bv))
    b.assign_fixed(Q_RECOMP, rows, 1)
    wcell = b.assign_advice(WORD_COL, rows, value)
    return bits, wcell


def mul_const(b: CircuitBuilder, x, c: int):
    val = None if x.value is None else x.value * c % P
    ca, _, cc = assign_vanilla(b, ql=c % P, qo=P - 1, va=x.value, vc=val)
    b.copy(ca, x)
    return cc


def add_const(b: CircuitBuilder, x, c: int):
    """x + c (compile-time constant c) in one vanilla row."""
    val = None if x.value is None else (x.value + c) % P
    ca, _, cc = assign_vanilla(b, ql=1, qc=c % P, qo=P - 1, va=x.value, vc=val)
    b.copy(ca, x)
    return cc


def add_scaled(b: CircuitBuilder, x, y, c: int):
    """x + c*y."""
    val = None if x.value is None or y.value is None else (x.value + c * y.value) % P
    ca, cb, cc = assign_vanilla(b, ql=1, qr=c % P, qo=P - 1, va=x.value, vb=y.value, vc=val)
    b.copy(ca, x)
    b.copy(cb, y)
    return cc


def range_check(b: CircuitBuilder, cell, num_bits: int):
    """cell < 2^num_bits (reference integrity.rs:632-651 quantity check)."""
    decompose_bits(b, cell, num_bits)


def conditional_equal(b: CircuitBuilder, sel, left, right):
    """sel * (left - right) == 0 (reference gadgets/conditional_equal.rs).
    sel need not be boolean (the partial-fulfillment check gates on a
    difference)."""
    d = sub_cells(b, left, right)
    z = mul_cells(b, sel, d)
    assert_equal_constant(b, z, 0)


def extended_or_relation(b: CircuitBuilder, sel, a, bb, c):
    """sel => (c == a or c == b) over pairs (reference
    gadgets/extended_or_relation.rs:34-63): four degree-3 products."""
    a1, a2 = a
    b1, b2 = bb
    c1, c2 = c
    for l, r in (
        (sub_cells(b, c1, a1), sub_cells(b, c1, b1)),
        (sub_cells(b, c2, a2), sub_cells(b, c2, b2)),
        (sub_cells(b, c1, a1), sub_cells(b, c2, b2)),
        (sub_cells(b, c1, b1), sub_cells(b, c2, a2)),
    ):
        prod = mul_cells(b, l, r)
        gated = mul_cells(b, sel, prod)
        assert_equal_constant(b, gated, 0)
